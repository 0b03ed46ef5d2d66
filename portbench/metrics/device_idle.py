"""The share of the traced stretch in which no operation ran on the
device: 1 - the union of the device operations' intervals over the
stretch, in %."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
