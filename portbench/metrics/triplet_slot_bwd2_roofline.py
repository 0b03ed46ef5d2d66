"""``csrc/triplet_slot.cu``'s second-order share of its roofline: the
frozen bounds of the traced calls over ``slot_jvp_kernel`` and
``slot_bwd2_kernel`` (with their ``sum_partials_kernel``), in %."""
from ._roofline import share


def read(run):
    return share(run, "triplet_slot_bwd2",
                 {"slot_jvp_kernel", "slot_bwd2_kernel"})
