"""Device milliseconds a step of every operation in the traced stretch
that is not one of the port's CUDA kernels (``dig_tpu_torch/csrc/``):
the model glue's PyTorch kernels, copies and sets, Adam."""
from ..core import trace


def read(run):
    if run.trace is None:
        return None
    return trace.glue_seconds(run.trace) * 1e3 / run.trace.steps
