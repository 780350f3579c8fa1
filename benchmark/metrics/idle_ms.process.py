"""Device-idle ms per burst while a program span outside the pipeline's
four stages is the innermost open one: the entry's steps (upload, noise
curves, SNR, finishing, orientation), its waits, and the pipeline's glue
(stacking, zeroing, the accumulated robustness). With the four stages'
idle ms and the idle outside any program span (the harness's), the whole
idle time of the third profiled pass (:mod:`benchmark.program_spans`)."""

from benchmark.program_spans import idle_ms, other_spans


def read(view):
    return idle_ms(view, other_spans(view))
