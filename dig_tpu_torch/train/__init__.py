from .checkpoint import Checkpointer, partial_restore
from .metrics import MetricLogger, Throughput
from .trainer import (Run3D, bucketed_force_loss, dense_loss, energy_force,
                      evaluate, make_bucketed_step_fns, make_dense_step_fns,
                      make_step_fns, step_lr)

__all__ = ["Checkpointer", "partial_restore", "MetricLogger", "Throughput",
           "Run3D", "bucketed_force_loss", "dense_loss", "energy_force",
           "evaluate", "make_bucketed_step_fns", "make_dense_step_fns",
           "make_step_fns", "step_lr"]
