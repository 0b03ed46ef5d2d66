"""Graph ops: segment reductions, gather / scatter helpers, radius graphs
(periodic ones too), triplet tables and geometry, bases, and the fused
kernels (cfconv, the triplet product, the packed-basis
and slot triplet kernels, the sorted-CSR segment sum), and SELL plans
(``ops.sell``). Mirrors ``dig_tpu.ops``: every name of its ``__all__``,
plus the port's kernels and ``spmm_bidir_sell``. Importing it builds
nothing: each kernel is built on its
first launch on the card.
"""
from . import sell
from .basis import cosine_cutoff, gaussian_rbf
from .cfconv import MASK_DIST, cfconv_fused, cfconv_reference
from .radius import (knn_graph_flat, radius_blocked_dropped,
                     radius_graph_flat, radius_graph_nk,
                     radius_graph_nk_blocked, radius_overflow)
from .pbc import pbc_overflow, radius_graph_pbc_flat
from .scatter import coalesce_mean, gather, scatter_sum_edges
from .segment import (segment_argmin, segment_max, segment_mean, segment_min,
                      segment_normalize, segment_softmax, segment_sum,
                      segment_sum_sorted, spmm_bidir_csr, spmm_bidir_sell)
from .triplet_product import fused_angle_product, fused_triplet_product
from .triplet_pt import basis_pt, fused_triplet_pt, pt_rows
from .triplets import (build_triplets, build_triplets_nk, nk_edge_distances,
                       nk_gather_nodes, torsion_angles, triplet_geometry,
                       triplet_kj_distances)

__all__ = [
    "segment_sum", "segment_sum_sorted", "segment_mean", "segment_max",
    "segment_min", "segment_softmax", "segment_normalize", "segment_argmin",
    "spmm_bidir_csr", "spmm_bidir_sell",
    "gather", "scatter_sum_edges", "coalesce_mean",
    "radius_graph_flat", "knn_graph_flat", "radius_overflow",
    "radius_graph_nk", "radius_graph_nk_blocked", "radius_blocked_dropped",
    "build_triplets", "build_triplets_nk", "nk_edge_distances",
    "nk_gather_nodes", "triplet_geometry",
    "torsion_angles", "triplet_kj_distances",
    "radius_graph_pbc_flat", "pbc_overflow",
    "fused_angle_product", "fused_triplet_product",
    "fused_triplet_pt", "basis_pt", "pt_rows",
    "cosine_cutoff", "gaussian_rbf", "MASK_DIST", "cfconv_fused",
    "cfconv_reference",
]
