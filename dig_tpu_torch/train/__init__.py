from .metrics import MetricLogger, Throughput
from .trainer import (dense_loss, make_dense_step_fns, make_step_fns,
                      step_lr)

__all__ = ["MetricLogger", "Throughput", "dense_loss", "make_dense_step_fns",
           "make_step_fns", "step_lr"]
