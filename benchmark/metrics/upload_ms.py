"""Host ms per burst in the program's ``process.upload`` span: the burst's
frames copied to the card as float32 (from pageable host memory in the host
cells). From the third profiled pass (:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import host_ms


def read(view):
    return host_ms(view, "process.upload")
