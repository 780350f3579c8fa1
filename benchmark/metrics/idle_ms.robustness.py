"""Device-idle ms per burst (no kernel, copy or memset running) while a
``robustness`` span of the program is the innermost open span of the calling
thread: the reference's guide statistics, and each compared frame's robustness map (K4, the noise-corrected distance, the 5x5 minimum). From the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import idle_ms


def read(view):
    return idle_ms(view, ("robustness",))
