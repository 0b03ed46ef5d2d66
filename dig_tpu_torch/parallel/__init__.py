"""Parallelism. Port of ``dig_tpu/parallel`` in progress: the host-side
graph partitioner (``partition.py``). The meshes, data / graph / tensor /
pipeline / expert parallelism and the halo exchange are still to port
(ROADMAP queue 1 item 17)."""
from .partition import (PartitionedGraph, build_partitions, edge_cut,
                        partition_graph, refine_partition)

__all__ = ["partition_graph", "refine_partition", "build_partitions",
           "PartitionedGraph", "edge_cut"]
