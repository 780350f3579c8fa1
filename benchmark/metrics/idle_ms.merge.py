"""Device-idle ms per burst (no kernel, copy or memset running) while a
``merge`` span of the program is the innermost open span of the calling
thread: the merge in whichever form the pipeline runs it: per frame (K5), per chunk (K5'), the fused K6 + K7, the reference merge and the refill. From the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import idle_ms


def read(view):
    return idle_ms(view, ("merge",))
