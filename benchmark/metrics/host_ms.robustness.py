"""Host ms per burst inside the program's ``robustness`` spans: the reference's guide statistics, and each compared frame's robustness map (K4, the noise-corrected distance, the 5x5 minimum). Read
from the program's span recorder in the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import host_ms


def read(view):
    return host_ms(view, "robustness")
