"""Large-scale graph learning. Port of ``dig_tpu/lsgraph`` in progress:
the data module (``synthetic_large_graph``, ``get_data``). The partitioned
loaders, histories, scalable models and GraphFM-IB are still to port
(ROADMAP queue 1 item 11)."""
from .data import get_data, synthetic_large_graph

__all__ = ["synthetic_large_graph", "get_data"]
