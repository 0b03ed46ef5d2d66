from .checkpoint import Checkpointer, partial_restore
from .debug import (assert_donation_discipline, collective_selfcheck,
                    debug_mode)
from .metrics import MetricLogger, Throughput
from .profiling import StepProfiler, profile_block
from .trainer import (Run3D, TrainState, bucketed_force_loss, dense_loss,
                      energy_force, evaluate, make_bucketed_step_fns,
                      make_dense_step_fns, make_step_fns, make_train_state,
                      step_lr)

__all__ = ["Checkpointer", "partial_restore", "MetricLogger", "Throughput",
           "Run3D", "TrainState", "make_train_state", "bucketed_force_loss",
           "dense_loss", "energy_force", "evaluate",
           "make_bucketed_step_fns", "make_dense_step_fns", "make_step_fns",
           "step_lr", "StepProfiler", "profile_block", "debug_mode",
           "assert_donation_discipline", "collective_selfcheck"]
