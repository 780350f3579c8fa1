"""Verbose-gated stage timing (twin of :mod:`hmsr_tpu.utils.timing`), and
the port's span recorder.

The reference's ``timer``/``getTime`` print tracing: a timed section ends in
``torch.cuda.synchronize()`` when its inputs or outputs lie on the card, so
the printed time is the device's, not the enqueue's.

The span recorder (:func:`span`, :func:`wait`, :func:`enable`,
:func:`collect`) times the stages where they run, without synchronising:
host intervals on the profiler's clock, which an operator or a benchmark
lays over a device trace.
"""

import contextlib
import threading
import time

import torch
from torch.autograd.profiler import record_function


def _sync(*trees):
    """Synchronise the card if any tensor in ``trees`` (nested tuples, lists
    and dict values) lies on it."""
    stack = list(trees)
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())


def getTime(current_time, label, print_time=True, space_size=50):
    """Print the elapsed time since ``current_time``; return a new timestamp."""
    if print_time:
        print(label, " " * (space_size - len(label)), ": ",
              round((time.perf_counter() - current_time) * 1000, 2), "milliseconds")
    return time.perf_counter()


def timer(func, enabled, start_s=None, end_s=None, space_size=50):
    """Wrap ``func`` with device-synchronised wall-clock printing; when
    ``enabled`` is falsy the function is returned untouched."""
    if not enabled:
        return func

    def wrapper(*args, **kwargs):
        _sync(args, kwargs)
        t1 = time.perf_counter()
        if start_s is not None:
            print(start_s)
        out = func(*args, **kwargs)
        _sync(out)
        if end_s is not None:
            print(end_s, " " * (space_size - len(end_s)), ": ",
                  round((time.perf_counter() - t1) * 1000, 2), "milliseconds")
        return out

    return wrapper


# ---- the span recorder
#
# Named host intervals around the program's stages, off by default. Off,
# :func:`span` and :func:`wait` return one shared no-op context after a
# single check of a module flag: no clock read, no allocation. On, each span
# records its name, its start and end on ``time.time_ns()`` (the clock of
# ``torch.profiler``'s timeline), the index of its enclosing span, the burst
# it belongs to and its thread; and, only while a profiler records, it also
# opens ``record_function("hmsr::<name>")`` around its stamps (entered before
# the start is read and left after the end is: while a profiler records the
# host, entering a range takes tens of us), so the span shows on the
# profiler's timeline over the device operations it launched.

#: prefix of a span's range in a profiler trace
RANGE_PREFIX = "hmsr::"

_profiling = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_on = False
_records = []           # [name, start_ns, end_ns, parent record, burst, tid, is_wait]
_burst = 0


class _Thread(threading.local):
    """Per thread: the open spans' records, and the native thread id."""

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()


_thread = _Thread()


class _Span:
    __slots__ = ("name", "wait", "new_burst", "record", "stack", "range")

    def __init__(self, name, wait, new_burst):
        self.name, self.wait, self.new_burst = name, wait, new_burst

    def __enter__(self):
        global _burst
        if self.new_burst:
            _burst += 1
        thread = _thread
        self.stack = stack = thread.stack
        self.range = None
        if _profiling():                # the range first: its start is stamped on entry
            self.range = record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.record = record = [self.name, time.time_ns(), 0, stack[-1] if stack else None,
                                _burst, thread.tid, self.wait]
        stack.append(record)
        _records.append(record)
        return self

    def __exit__(self, *exc):
        self.record[2] = time.time_ns()
        self.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name, new_burst=False):
    """A context manager around a stage named ``name`` (``<layer>.<step>``,
    or the layer's name for a pipeline stage); ``new_burst`` advances the
    burst id first (the entry's root span). A no-op while recording is off."""
    if not _on:
        return _NOOP
    return _Span(name, False, new_burst)


def wait(name):
    """A :func:`span` that marks the host blocked on the card (a read of a
    device value, a synchronous copy)."""
    if not _on:
        return _NOOP
    return _Span(name, True, False)


def enable():
    """Start recording spans (into the buffer :func:`collect` drains)."""
    global _on
    _on = True


def disable():
    """Stop recording; what was recorded stays for :func:`collect`."""
    global _on
    _on = False


def enabled():
    return _on


def collect():
    """Drain the buffer: ``{"spans": [...], "counts": {...}}``. Each span is
    a dict of ``name``, ``start_ns``, ``end_ns`` (``time.time_ns()``),
    ``parent`` (its enclosing span's index in the list, -1 for none),
    ``burst``, ``tid`` (the native thread id) and ``wait``; ``counts``
    holds ``entries`` (span name -> times entered) and ``waits``. A span
    still open is drained with ``end_ns`` 0; call it outside every span."""
    global _records
    recs, _records = _records, []
    index = {id(r): i for i, r in enumerate(recs)}
    spans, entries = [], {}
    for name, t0, t1, parent, burst, tid, is_wait in recs:
        spans.append(dict(name=name, start_ns=t0, end_ns=t1,
                          parent=index.get(id(parent), -1), burst=burst, tid=tid,
                          wait=is_wait))
        entries[name] = entries.get(name, 0) + 1
    return {"spans": spans,
            "counts": {"entries": entries, "waits": sum(1 for s in spans if s["wait"])}}


@contextlib.contextmanager
def recording():
    """Record spans inside the block; where recording was off before, it is
    switched off again after it and what the block recorded is dropped."""
    was, start = _on, len(_records)
    enable()
    try:
        yield
    finally:
        if not was:
            disable()
            del _records[start:]

