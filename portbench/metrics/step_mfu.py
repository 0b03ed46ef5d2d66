"""The model FLOPs of the window's steps (``flops/<config>.py``, over
real atoms, pairs and triplets) over the window's seconds, as a share of
the card's float32 peak outside the tensor cores (67 TFLOP/s), in %."""
from ..core.peaks import PEAK_FLOPS


def read(run):
    w = run.window
    return 100.0 * run.flops(w.batches) / w.seconds / PEAK_FLOPS["f32"]
