"""Device-idle ms per burst (no kernel, copy or memset running) while a
``kernels`` span of the program is the innermost open span of the calling
thread: the merge kernels' covariance estimation of each compared frame and of the reference. From the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import idle_ms


def read(view):
    return idle_ms(view, ("kernels",))
