"""Seconds from the process's start to the first timed step: imports,
molecules, weights, model, pool, kernel builds or loads, and the four
steps that warm every batch (the first three of them checked)."""


def read(run):
    return run.setup_s
