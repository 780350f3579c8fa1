"""Host ms per burst inside the program's ``merge`` spans: the merge in whichever form the pipeline runs it: per frame (K5), per chunk (K5'), the fused K6 + K7, the reference merge and the refill. Read
from the program's span recorder in the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import host_ms


def read(view):
    return host_ms(view, "merge")
