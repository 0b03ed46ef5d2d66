"""Native (C++) host-side graph machinery, loaded with ctypes. Port of
``dig_tpu/native``.

``partition.cpp`` (a copy of the JAX package's) holds the balanced k-way
partitioner and the one-hop relabel of the partitioned large-graph path;
all device compute is PyTorch and the CUDA kernels. The library is built
with ``g++`` at first use into ``dig_tpu_torch/_build/`` (``build.py``);
the JAX package's prebuilt library is never loaded.

When the library cannot be built or loaded (no ``g++``), ``available()``
is false, ``metis_partition`` and ``relabel_one_hop`` return None (with
one warning that says why), and the callers take their numpy versions
(``parallel.partition.partition_graph``, ``lsgraph.SubgraphLoader``).
"""
from __future__ import annotations

import ctypes
import subprocess
import warnings
from typing import Optional

import numpy as np

from . import build as _build

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(_build.build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        warnings.warn(f"dig_tpu_torch.native unavailable, numpy fallbacks "
                      f"in use: {exc}")
        return None
    p64, i64 = ctypes.POINTER(ctypes.c_int64), ctypes.c_int64
    lib.dig_partition.restype = ctypes.c_int
    # rowptr, col, num_nodes, num_parts, out part_of
    lib.dig_partition.argtypes = [p64, p64, i64, i64, p64]
    lib.dig_relabel_one_hop.restype = i64
    # rowptr, col, idx (batch nodes), num_idx, num_nodes, out rowptr,
    # out col, out n_id, max_out_edges, max_out_nodes
    lib.dig_relabel_one_hop.argtypes = [p64, p64, p64, i64, i64, p64, p64,
                                        p64, i64, i64]
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


def _to_csr(senders: np.ndarray, receivers: np.ndarray, num_nodes: int):
    """CSR keyed by ``senders``: row v lists the ``receivers`` of v's edges
    in edge order."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    order = np.argsort(senders, kind="stable")
    col = np.ascontiguousarray(receivers[order])
    deg = np.bincount(senders, minlength=num_nodes)
    rowptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    return rowptr, col


def metis_partition(senders, receivers, num_nodes: int,
                    num_parts: int) -> Optional[np.ndarray]:
    """Balanced k-way partition via the C++ GGGP+FM partitioner.

    Returns part_of[num_nodes] or None when the native lib is unavailable
    (caller falls back to the numpy partitioner).
    """
    lib = _load()
    if lib is None:
        return None
    rowptr, col = _to_csr(senders, receivers, num_nodes)
    out = np.zeros(num_nodes, np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    rc = lib.dig_partition(
        rowptr.ctypes.data_as(p64), col.ctypes.data_as(p64),
        ctypes.c_int64(num_nodes), ctypes.c_int64(num_parts),
        out.ctypes.data_as(p64))
    if rc != 0:
        return None
    return out


def relabel_one_hop(senders, receivers, idx, num_nodes: int,
                    max_out_edges: Optional[int] = None,
                    max_out_nodes: Optional[int] = None):
    """C++ one-hop subgraph extraction + relabel (reference semantics:
    ``csrc/cpu/relabel_cpu.cpp:5-102`` — batch nodes first, out-of-batch
    neighbors appended after). Returns (out_rowptr, out_col, n_id) or None.

    The neighbours of a batch node v are the ``receivers`` of the edges
    whose ``senders`` entry is v, in edge order. To gather each node's
    in-neighbours (messages flowing sender -> receiver), pass the edge
    list's receivers first and its senders second, as
    ``lsgraph.SubgraphLoader`` does.
    """
    lib = _load()
    if lib is None:
        return None
    rowptr, col = _to_csr(senders, receivers, num_nodes)
    idx = np.ascontiguousarray(np.asarray(idx, np.int64))
    B = len(idx)
    moe = int(max_out_edges or len(col))
    mon = int(max_out_nodes or num_nodes)
    out_rowptr = np.zeros(B + 1, np.int64)
    out_col = np.zeros(moe, np.int64)
    out_nid = np.zeros(mon, np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n_out = lib.dig_relabel_one_hop(
        rowptr.ctypes.data_as(p64), col.ctypes.data_as(p64),
        idx.ctypes.data_as(p64), ctypes.c_int64(B), ctypes.c_int64(num_nodes),
        out_rowptr.ctypes.data_as(p64), out_col.ctypes.data_as(p64),
        out_nid.ctypes.data_as(p64), ctypes.c_int64(moe), ctypes.c_int64(mon))
    if n_out < 0:
        return None
    ne = int(out_rowptr[B])
    return out_rowptr, out_col[:ne], out_nid[:int(n_out)]
