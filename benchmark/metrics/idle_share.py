"""Share of the profiled bursts' wall time, in %, in which no kernel ran on
the card (copies and memsets do not count as busy)."""

from benchmark.trace import union_ns


def read(view):
    kernels = [(o.start_ns, o.end_ns) for o in view.ops_of_kind("kernel")]
    if not kernels:
        return None
    return 100.0 * (1.0 - union_ns(kernels, view.lo, view.hi) / (view.hi - view.lo))
