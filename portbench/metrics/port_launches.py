"""Launches a step of the port's kernels, from the ops' own counters
(``dig_tpu_torch.ops``: cfconv, triplet_slot, triplet_product, triplet_pt,
segment_csr), over the window."""


def read(run):
    return sum(run.window.launches.values()) / run.window.steps
