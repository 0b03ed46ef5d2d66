"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates at
the card's 700 W limit (NVIDIA's H100 data sheet): the yardstick of
every roofline and MFU share. The special-function units give 16 results
a clock per SM (CUDA C++ Programming Guide, arithmetic instruction
throughput, compute capability 9.0) on 132 SMs at the 1,980 MHz boost
clock."""
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
SFU_OPS = 132 * 16 * 1980e6
