"""Device-idle ms per burst (no kernel, copy or memset running) while a
``align`` span of the program is the innermost open span of the calling
thread: the reference's grey image and pyramid, and each compared frame's grey image, alignment (K1-K3) and flow on the raw tile grid. From the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import idle_ms


def read(view):
    return idle_ms(view, ("align",))
