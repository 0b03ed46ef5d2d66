"""What the ``<kernel>_roofline`` readers share: the frozen bounds of the
traced stretch's calls of a kernel family over the family's device time
in the trace, in %. A reader whose family did not run, or ran another
number of times than the bounds count, gives nothing."""
import sys

from ..core import trace


def share(run, family: str, kernels) -> float:
    tr = run.trace
    if tr is None:
        return None
    calls = run.kernel_calls(tr.batches).get(family)
    if calls is None:
        return None
    launches, bound_ms = calls
    if tr.launches.get(family) != launches:
        print(f"{family}: {tr.launches.get(family)} launches traced, the "
              f"bounds count {launches}; no roofline", file=sys.stderr)
        return None
    seconds = trace.kernel_seconds(tr, kernels)
    return 100.0 * bound_ms / 1e3 / seconds if seconds > 0 else None
