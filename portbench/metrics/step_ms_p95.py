"""The 95th percentile of all the window's step times, read from the CUDA
events recorded at the step boundaries."""
import numpy as np


def read(run):
    return float(np.percentile(run.window.step_ms, 95))
