"""Host ms per burst inside the program's wait spans, where the host blocks
on the card: the upload, the SNR's read of the mean, the noise curves'
copy, the finishing's synchronous copies. From the third profiled pass
(:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import wait_ms


def read(view):
    return wait_ms(view)
