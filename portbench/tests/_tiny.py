"""Small pools of each cell's traffic for the CPU tests: the mix with
``n`` molecules in each part and slot bucket (its parts match its buckets
one to one), four batches. Widths are the configuration's."""
from portbench.core import spec


def shrink(t: dict, n: int = 1) -> dict:
    """Traffic mix ``t`` with ``n`` molecules a part and slot bucket."""
    return {**t, "slots": {s: n for s in t["slots"]},
            "molecules": {**t["molecules"], "batch": [
                dict(p, count=n) for p in t["molecules"]["batch"]]}}


def use_tiny(monkeypatch, n: int = 1) -> None:
    """Make every traffic mix the harness reads :func:`shrink`'s."""
    read = spec.traffic
    monkeypatch.setattr(spec, "traffic", lambda name: shrink(read(name), n))
