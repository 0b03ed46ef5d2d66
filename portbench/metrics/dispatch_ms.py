"""Host milliseconds from a step's start to the return of the port's
``train_step``, the mean over the window's steps (profiler off)."""
import statistics


def read(run):
    return statistics.fmean(run.window.dispatch_ms)
