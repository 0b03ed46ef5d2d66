"""Least time of one call of the cfconv kernels (``csrc/cfconv.cu``) for
the work its data needs: in-cutoff pairs only (the others contribute
exactly zero), each input read once and each output written once, against
the published peaks. A frozen copy of ``chip_smoke.py``'s ``bounds``,
taking sizes in place of tensors."""
from __future__ import annotations

from ..core.peaks import PEAK_BYTES, PEAK_FLOPS, SFU_OPS


def bound_ms(G: int, n: int, F: int, R: int, pairs: int, prec: str,
             kind: str, need_dist: bool = False) -> float:
    """``kind``: "fwd" or "bwd"; G slots of n atoms, F filters, R
    Gaussians, ``pairs`` real in-cutoff pairs; float32 operands (bf16
    ``vj`` under "bf16")."""
    el_dist = G * n * n * 4
    el_vj = G * n * F * (2 if prec == "bf16" else 4)
    w_bytes = (R * F + F + F * F + F) * 4
    out_bytes = G * n * F * 4
    P = pairs
    if kind == "fwd":
        flops = 2 * P * F * (R + F) + 3 * P * F
        mufu = P * (R + 2 * F + 1)
        nbytes = el_dist + el_vj + w_bytes + out_bytes
    else:
        # R basis exps, and per feature one exp(-|pre|) shared by the
        # softplus and the sigmoid, a log and a reciprocal
        flops = 2 * P * F * (2 * R + 3 * F) + 10 * P * F
        mufu = P * (R + 3 * F + 1)
        if need_dist:
            flops += 2 * P * F * R + 2 * P * (F + R)
            mufu += P
        nbytes = (el_dist + el_vj + w_bytes + out_bytes
                  + el_dist + el_vj + w_bytes)
    t_ops = max(flops / PEAK_FLOPS[prec], mufu / SFU_OPS)
    return max(t_ops, nbytes / PEAK_BYTES) * 1e3
