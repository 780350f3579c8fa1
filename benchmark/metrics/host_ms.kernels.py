"""Host ms per burst inside the program's ``kernels`` spans: the merge kernels' covariance estimation of each compared frame and of the reference. Read
from the program's span recorder in the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import host_ms


def read(view):
    return host_ms(view, "kernels")
