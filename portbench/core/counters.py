"""The launch counters the port's ops keep (module-level integers of
``dig_tpu_torch.ops``), read as they stand. Every kernel family of
``csrc/`` is listed, those no cell runs yet too, so that a cell added
later counts its kernels without an edit here. Counters that count a
subset of another (``launches_bwd_dpt``, ``launches_bwd_basis``,
``launches_geom_bwd_dgeo``) are left out of the families."""
from __future__ import annotations

import importlib

FAMILIES = {
    "cfconv": ("cfconv", ("launches_fwd", "launches_bwd")),
    "triplet_slot": ("triplet_slot", ("launches_fwd", "launches_bwd")),
    "triplet_slot_bwd2": ("triplet_slot", ("launches_bwd2",)),
    "triplet_slot_geom": ("triplet_slot", ("launches_geom_fwd",
                                           "launches_geom_bwd",
                                           "launches_geom_bwd2")),
    "triplet_product": ("triplet_product", ("launches_fwd", "launches_bwd",
                                            "launches_bwd2")),
    "triplet_pt": ("triplet_pt", ("launches_fwd", "launches_bwd",
                                  "launches_bwd2")),
    "segment_csr": ("segment_csr", ("launches", "launches_chunked")),
}


def read() -> dict:
    """``{family: launches so far}``."""
    out = {}
    for family, (mod, names) in FAMILIES.items():
        m = importlib.import_module(f"dig_tpu_torch.ops.{mod}")
        out[family] = sum(int(getattr(m, n, 0)) for n in names)
    return out
