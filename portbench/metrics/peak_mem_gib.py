"""``torch.cuda.max_memory_allocated()`` over set-up, window and traced
stretch, after ``reset_peak_memory_stats()`` at the start, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
