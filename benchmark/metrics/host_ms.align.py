"""Host ms per burst inside the program's ``align`` spans: the reference's grey image and pyramid, and each compared frame's grey image, alignment (K1-K3) and flow on the raw tile grid. Read
from the program's span recorder in the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import host_ms


def read(view):
    return host_ms(view, "align")
