"""From a profiler trace and the harness's spans to per-layer numbers.

A traced run records device operations (kernels, copies, memsets), host
operations (PyTorch's operators, with the profiler's id), the CUDA runtime
calls that launched work (with CUPTI's correlation id) and the benchmark's
spans (named host intervals around the calls into each layer,
``bench::<name>``). A device operation launched inside one of PyTorch's
operators is linked to that operator (``linked_correlation_id``); one
launched through ctypes, outside any operator, is found through its
runtime call (``correlation_id``). Each belongs to the innermost span that
encloses that host event: PyTorch's kernels and the hand-written ones
alike, with no table of who launches what.
"""

from typing import NamedTuple, Optional

SPAN_PREFIX = "bench::"
#: the name of a gap or an operation that no span encloses
OUTSIDE = "harness"


class DeviceOp(NamedTuple):
    name: str
    kind: str           # "kernel", "memcpy" or "memset"
    start_ns: int
    end_ns: int
    corr: int           # CUPTI's id, shared with the runtime call that launched it
    link: int = 0       # the id of the operator it was launched in; 0 for none


class Launch(NamedTuple):
    """A host event a device operation goes back to (an operator, or a
    runtime call): its id, its start, its thread."""
    corr: int
    ts_ns: int
    tid: int


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    tid: int


def op_kind(name):
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def from_profiler(prof):
    """``(ops, operators, calls, spans)`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, operators, calls, spans = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):     # not the device-side copy of a span
                ops.append(DeviceOp(name, op_kind(name), start, end, e.correlation_id(),
                                    e.linked_correlation_id()))
            continue
        if name.startswith(SPAN_PREFIX):
            spans.append(Span(name[len(SPAN_PREFIX):], start, end, e.start_thread_id()))
        host = Launch(e.correlation_id(), start, e.start_thread_id())
        if name.startswith("cu"):                   # a CUDA runtime or driver call
            calls.append(host)
        elif e.linked_correlation_id() == 0:        # an operator or a span
            operators.append(host)
    return ops, operators, calls, spans


def enclosing(points, spans):
    """For each (ts_ns, tid) in ``points`` the name of the innermost span of
    that thread that holds it, or None. Spans of one thread nest."""
    out = [None] * len(points)
    by_tid = {}
    for i, (ts, tid) in enumerate(points):
        by_tid.setdefault(tid, []).append((ts, i))
    for tid, pts in by_tid.items():
        # (time, order, ...): at one instant a span ends before the next starts
        # and a point inside both sees the one still open
        events = [(s.start_ns, 1, s.end_ns, s.name) for s in spans if s.tid == tid]
        events += [(s.end_ns, 0, s.start_ns, s.name) for s in spans if s.tid == tid]
        events += [(ts, 2, i, None) for ts, i in pts]
        events.sort(key=lambda ev: (ev[0], ev[1]))
        stack = []
        for t, kind, extra, name in events:
            if kind == 1:
                stack.append((name, t, extra))
            elif kind == 0:
                for k in range(len(stack) - 1, -1, -1):
                    if stack[k][0] == name and stack[k][1] == extra:
                        del stack[k]
                        break
            else:
                out[extra] = stack[-1][0] if stack else None
    return out


class Attributed(NamedTuple):
    ops: list           # DeviceOp
    span_of: list       # the span name of each op, None where none encloses its launch
    unmatched: int      # ops whose host event the trace does not hold


def attribute(ops, operators, spans, calls=()):
    """Each device op's span: the innermost span enclosing the start of the
    operator it is linked to, or else of the runtime call that launched it."""
    by_link = {h.corr: h for h in operators}
    by_corr = {h.corr: h for h in calls}
    points, idx, unmatched = [], [], 0
    for i, op in enumerate(ops):
        h = by_link.get(op.link) if op.link else None
        h = h or by_corr.get(op.corr)
        if h is None:
            unmatched += 1
            continue
        points.append((h.ts_ns, h.tid))
        idx.append(i)
    span_of = [None] * len(ops)
    for i, n in zip(idx, enclosing(points, spans)):
        span_of[i] = n
    return Attributed(list(ops), span_of, unmatched)


def union_ns(intervals, lo=None, hi=None):
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(ops, spans, lo, hi, top=10):
    """The ``top`` longest intervals in [lo, hi] in which no device op ran, as
    ``[name, seconds]``, each named by the innermost span the host was in at
    the gap's middle (:data:`OUTSIDE` for none)."""
    busy = sorted((max(o.start_ns, lo), min(o.end_ns, hi)) for o in ops
                  if o.end_ns > lo and o.start_ns < hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top]
    tid = spans[0].tid if spans else 0
    names = enclosing([((s + e) // 2, tid) for s, e in gaps], spans)
    return [[n or OUTSIDE, (e - s) / 1e9] for (s, e), n in zip(gaps, names)]


#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 120


def top_ops(ops, top=10):
    """The ``top`` device operations by total time, as ``[name, seconds]``,
    names cut to :data:`NAME_CHARS`."""
    tot = {}
    for o in ops:
        n = o.name[:NAME_CHARS]
        tot[n] = tot.get(n, 0) + (o.end_ns - o.start_ns)
    return [[n, ns / 1e9] for n, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


class View:
    """What a per-layer metric's reader sees of a traced run.

    Two profiles of a few bursts each: ``ops`` from one that records the
    device alone (the host's pace as unprofiled, so its busy and idle times
    hold), ``bursts`` of them between ``lo`` and ``hi`` in the profiler's
    clock; and ``att``, the device ops of one that records the host's
    operators too (slower on the host, the same kernels), attributed to the
    spans, over ``att_bursts`` bursts, with ``entered`` the names of the
    spans entered there. ``host``: per span name, the host seconds spent
    inside it over the measured window, of ``window_bursts`` bursts;
    ``latencies``: the seconds of every burst of the window; ``cell``: the cell's configuration and traffic files; ``shape``: the
    burst's size and the tile size the SNR rule gives it."""

    def __init__(self, ops, bursts, lo, hi, att, spans, att_bursts):
        self.ops, self.bursts, self.lo, self.hi = ops, bursts, lo, hi
        self.att, self.att_bursts = att, att_bursts
        self.entered = {s.name for s in spans}
        self.host, self.window_bursts, self.latencies = {}, 0, []
        self.cell, self.shape = {}, {}

    def device_ms(self, names, kinds=("kernel", "memcpy", "memset")) -> Optional[float]:
        """Device ms per burst of the ops attributed to any span in
        ``names``; None where none of them was entered."""
        names = set(names)
        if not self.att.ops or not names & self.entered:
            return None
        ns = sum(o.end_ns - o.start_ns for o, n in zip(self.att.ops, self.att.span_of)
                 if n in names and o.kind in kinds)
        return ns / 1e6 / self.att_bursts

    def ops_of_kind(self, kind):
        return [o for o in self.ops if o.kind == kind]

    def host_ms(self, name) -> Optional[float]:
        """Host ms per burst inside span ``name`` over the window; None where
        it was never entered."""
        if name not in self.host or not self.window_bursts:
            return None
        return 1e3 * self.host[name] / self.window_bursts


def percentile_sorted(values, q):
    """The q-quantile (0..1) of ``values`` by linear interpolation between
    order statistics (numpy's default rule)."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    i = int(pos)
    j = min(i + 1, len(v) - 1)
    return v[i] + (v[j] - v[i]) * (pos - i)

