"""Molecules of every step completed in the window over the window's
seconds (host clock, the window ending when the device has finished)."""


def read(run):
    w = run.window
    return sum(run.graphs_per_batch[i] for i in w.batches) / w.seconds
