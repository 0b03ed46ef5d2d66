"""Parallelism. Port of ``dig_tpu/parallel`` on ``torch.distributed``: one
process a rank, each running the same program on its shard (the JAX
package runs one controller over a ``shard_map`` mesh).

* ``mesh``        — ``DeviceMesh`` construction, a rank's batch slab,
                    broadcast from the first rank.
* ``distributed`` — the process-group entry point (torchrun's environment),
                    local spawning on a file store, checkpoint-on-signal,
                    the restartable loader.
* ``partition``   — host-side graph partitioner (greedy BFS / C++
                    refinement).
* ``halo``        — halo exchanges (all-gather, all-to-all, ring) and the
                    partitioned sums.
* ``dp`` / ``gp`` / ``tp`` / ``pp`` / ``ep`` — data, graph, tensor,
                    pipeline and expert parallelism; ``gp_models`` the
                    graph-parallel models, whose neighbour sums run
                    through the sorted-CSR kernel on the card.
* ``comm``        — the collectives with autograd and their counts.
"""
from .mesh import (
    make_mesh,
    shard_graph_batch,
    replicate,
    data_parallel_sharding,
    concat_local_shards,
)
from .partition import (PartitionedGraph, build_partitions, edge_cut,
                        partition_graph, refine_partition)
from .halo import (halo_exchange_sum, halo_exchange_sum_ring,
                   partitioned_spmm, build_exchange_plan, build_ring_plan)
from .dp import make_dp_train_step, make_dp_eval_step
from .gp import (GPGraph, prepare_gp_graph, slab_layout,
                 make_gp_train_step, make_gp_engine,
                 GPLocalGraph, unslab_layout)
from .tp import (make_tp_train_step, make_tp_eval_step, tp_param_specs,
                 tp_shard)
from .pp import make_pp_train_step, pipeline_apply, pp_shard_params
from .ep import (make_ep_moe, init_moe_params, ep_shard_params,
                 moe_dense_reference)
from .distributed import init_local, initialize, spawn_local

__all__ = [
    "make_mesh", "shard_graph_batch", "replicate", "data_parallel_sharding",
    "concat_local_shards",
    "partition_graph", "refine_partition", "PartitionedGraph",
    "build_partitions", "edge_cut",
    "halo_exchange_sum", "halo_exchange_sum_ring", "partitioned_spmm",
    "build_exchange_plan", "build_ring_plan",
    "make_dp_train_step", "make_dp_eval_step",
    "GPGraph", "prepare_gp_graph", "slab_layout", "make_gp_train_step",
    "make_gp_engine", "GPLocalGraph", "unslab_layout",
    "make_tp_train_step", "make_tp_eval_step", "tp_param_specs", "tp_shard",
    "make_pp_train_step", "pipeline_apply", "pp_shard_params",
    "make_ep_moe", "init_moe_params", "ep_shard_params",
    "moe_dense_reference", "initialize", "init_local", "spawn_local",
]
