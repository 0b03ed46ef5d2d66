from .rgcn import RGCN
from .flow_utils import (one_hot_add, one_hot_minus, one_hot_argmax_st,
                         build_flow_masks, FlowMasks)
from .graphdf import DisGraphAF, GraphFlowModelDF
from .graphaf import MaskedGraphAF, GraphFlowModelAF
from .graphebm import EnergyFunc, langevin_sample

__all__ = [
    "RGCN", "one_hot_add", "one_hot_minus", "one_hot_argmax_st",
    "build_flow_masks", "FlowMasks",
    "DisGraphAF", "GraphFlowModelDF",
    "MaskedGraphAF", "GraphFlowModelAF",
    "EnergyFunc", "langevin_sample",
]
