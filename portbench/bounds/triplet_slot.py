"""Least time of one call of the slot kernels (``csrc/triplet_slot.cu``)
for the work its data needs, against the published peaks: real triplets
only (m2T = 0 contributes exactly zero). Bytes: each input read once where
a real triplet needs it (pt's column and the gathered x row of each real
triplet, the cotangent row of each edge that owns one), m2T, lj and the
weights in full, each output written in full, all in the types the
function takes and returns. Frozen copies of ``chip_smoke.py``'s
``sn_bounds`` and ``sf_bwd2_bounds``, taking sizes in place of tensors.

``work``: ``triplets`` (real), ``x_rows`` (distinct kj rows they gather),
``tri_edges`` (edges that own one). E edge rows of C channels, pt
``[K, R, E]``, ws ``[nk, C]``, wt ``[ntk, C]``, m2T ``[K, E]`` in x's
type, lj ``[1, E]`` int32; ``itemsize`` is x's (and pt's, ws's, wt's)."""
from __future__ import annotations

from ..core.peaks import PEAK_BYTES, PEAK_FLOPS


def _common(E, K, R, C, nk, ntk, work, itemsize):
    NB = nk + ntk
    T = work["triplets"]
    w = (nk + ntk) * C * itemsize
    inputs = (work["x_rows"] * C * itemsize + T * R * itemsize
              + K * E * itemsize + E * 4 + w)
    return NB, T, w, inputs


def _ms(flops, nbytes, prec):
    return max(flops / PEAK_FLOPS[prec], nbytes / PEAK_BYTES) * 1e3


def fwd_bwd_ms(E, K, R, C, nk, ntk, work, itemsize, prec, kind,
               need_dpt=False) -> float:
    """``kind`` "fwd" (the forward) or "bwd" (the backward, with
    ``need_dpt`` the basis cotangent)."""
    NB, T, w, inputs = _common(E, K, R, C, nk, ntk, work, itemsize)
    x_bytes = E * C * itemsize
    if kind == "fwd":
        return _ms(T * (2 * C * NB + 3 * C + NB), inputs + x_bytes, prec)
    flops = T * (4 * C * NB + 7 * C + NB)
    nbytes = inputs + work["tri_edges"] * C * itemsize + x_bytes + w
    if need_dpt:
        flops += T * (2 * C * NB + 2 * NB)
        nbytes += K * R * E * itemsize
    return _ms(flops, nbytes, prec)


def bwd2_ms(E, K, R, C, nk, ntk, work, itemsize, prec) -> float:
    """The second-order call (``slot_jvp_kernel``, ``slot_bwd2_kernel``
    and their partial sums): the four basis products, the weight
    gradients and the basis cotangents per real triplet."""
    NB, T, w, _ = _common(E, K, R, C, nk, ntk, work, itemsize)
    nbytes = (2 * work["x_rows"] * C * itemsize + 2 * T * R * itemsize
              + work["tri_edges"] * C * itemsize + K * E * itemsize + E * 4
              + w + E * C * itemsize + E * C * itemsize
              + K * R * E * itemsize + w)
    return _ms(T * (12 * C * NB + 18 * C + 8 * NB), nbytes, prec)
