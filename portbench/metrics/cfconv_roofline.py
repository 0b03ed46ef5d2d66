"""``csrc/cfconv.cu``'s share of its roofline: the frozen bounds
(``bounds/cfconv.py``) of the traced calls over the forward and backward
kernels' device time (their partial sums included), in %."""
from ._roofline import share


def read(run):
    return share(run, "cfconv", {"cfconv_fwd_kernel", "cfconv_bwd_kernel"})
