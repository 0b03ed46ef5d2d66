"""``csrc/triplet_slot.cu``'s forward and backward share of their
roofline: the frozen bounds (``bounds/triplet_slot.py``) of the traced
calls over ``slot_fwd_kernel`` and ``slot_bwd_kernel`` (with their
``sum_partials_kernel``), in %."""
from ._roofline import share


def read(run):
    return share(run, "triplet_slot", {"slot_fwd_kernel", "slot_bwd_kernel"})
