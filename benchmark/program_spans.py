"""The program's own spans laid over a device trace: host ms, device-idle ms
and device ms per stage, from a third profiled pass.

The port records named host spans where its stages run
(``hmsr_tpu_torch.utils.timing``: ``span``, ``wait``, ``enable``,
``collect``), stamped on ``time.time_ns()``, the clock of the profiler's
timeline. The first reader of a metric of this module to be read runs the
pass, once per run and on the card alone, after the harness's two profiled
passes and their readers: one warm burst; CUPTI detached, which those
passes leave attached (:func:`detach_cupti`); then, with the recorder on,
:data:`benchmark.run.TRACED_BURSTS` bursts unprofiled (the host's spans at
its own pace) and as many under ``torch.profiler`` with the device's
activity alone (device operations and the runtime calls that launched
them; tracing the runtime calls slows the host by a third or more, as in
the harness's first profile); then the recorder off. The bursts are the
cell's (its configuration, traffic and burst size), made from
:data:`PASS_SEED`.

Per burst:

- host ns of every span name, the union of its spans, and of the wait
  spans, from the unprofiled bursts;
- from the profiled bursts, device-idle ns (no kernel, copy or memset
  running) per innermost open program span of the calling thread (None: no
  span open, the harness's own time), the parts adding up to the profile's
  whole idle time; and device ns and kernel launches per innermost program
  span, each device operation placed by the runtime call that launched it,
  as the harness's ``stage_ms.*`` place theirs
  (:func:`benchmark.trace.attribute`).

A program without the recorder, and a run off the card, read nothing. The
pass is an extra: where it fails, its metrics read nothing and the run goes
on (the traceback goes to standard error).
"""

import collections
import copy
import os
import sys
import threading
import time
import traceback
from typing import NamedTuple, Optional

from benchmark.trace import Span, attribute, enclosing, union_ns

#: the stages of the pipeline, as the program names their spans
STAGES = ("align", "robustness", "kernels", "merge")
#: the seed of the pass's burst (the pass's numbers do not depend on the
#: scene: the launches and the shapes are the cell's)
PASS_SEED = 1717171717171
#: the prefix of the program's spans as ranges in a profiler trace
RANGE_PREFIX = "hmsr::"


class Pass(NamedTuple):
    bursts: int
    lo: int             # the profiled window on the profiler's clock
    hi: int
    host_ns: dict       # span name -> ns inside its spans
    wait_ns: int        # ns inside wait spans
    idle_ns: dict       # innermost span name (None: none open) -> device-idle ns
    device_ns: dict     # innermost span name (None: none open) -> device ns
    launches: dict      # innermost span name (None: none open) -> kernels
    entries: dict       # span name -> times entered


def host_times(records, lo=None, hi=None):
    """``(host ns per span name, host ns inside wait spans)`` of span
    ``records``, each the union of the spans' intervals."""
    by_name = collections.defaultdict(list)
    for r in records:
        by_name[r["name"]].append((r["start_ns"], r["end_ns"]))
    return ({n: union_ns(iv, lo, hi) for n, iv in by_name.items()},
            union_ns([(r["start_ns"], r["end_ns"]) for r in records if r["wait"]], lo, hi))


def idle_pieces(busy, lo, hi, cuts):
    """The intervals of [lo, hi] that no interval of ``busy`` covers, cut
    at every time in ``cuts``."""
    gaps, t = [], lo
    for s, e in sorted(busy):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    cuts = sorted(c for c in set(cuts) if lo < c < hi)
    pieces, k = [], 0
    for s, e in gaps:
        while k < len(cuts) and cuts[k] <= s:
            k += 1
        j = k
        while j < len(cuts) and cuts[j] < e:
            pieces.append((s, cuts[j]))
            s = cuts[j]
            j += 1
        pieces.append((s, e))
    return pieces


def analyse(records, ops, calls, lo, hi, bursts, tid, host=None):
    """A :class:`Pass` from the program's span ``records`` of the calling
    thread (:func:`hmsr_tpu_torch.utils.timing.collect`'s dicts), the
    device ``ops`` (:class:`benchmark.trace.DeviceOp`) and the runtime
    ``calls`` (:class:`benchmark.trace.Launch`) of a profile of ``bursts``
    bursts over [lo, hi]; ``tid`` is the calling thread's id in the
    profile's runtime calls. ``host``: the records of as many unprofiled
    bursts, for the host times (by default the profiled ones')."""
    spans = [Span(r["name"], r["start_ns"], r["end_ns"], tid) for r in records]
    host_ns, wait_ns = host_times(records, lo, hi) if host is None else host_times(host)
    pieces = idle_pieces([(o.start_ns, o.end_ns) for o in ops], lo, hi,
                         [t for s in spans for t in (s.start_ns, s.end_ns)])
    idle_ns = collections.Counter()
    for (s, e), n in zip(pieces, enclosing([((s + e) // 2, tid) for s, e in pieces], spans)):
        idle_ns[n] += e - s
    att = attribute(ops, [], spans, calls)
    device_ns, launches = collections.Counter(), collections.Counter()
    for o, n in zip(att.ops, att.span_of):
        device_ns[n] += o.end_ns - o.start_ns
        launches[n] += o.kind == "kernel"
    return Pass(bursts, lo, hi, host_ns, wait_ns, dict(idle_ns), dict(device_ns),
                dict(launches), dict(collections.Counter(r["name"] for r in records)))


def program_pass(view, device="cuda") -> Optional[Pass]:
    """The pass of this run, run on first use and kept on the ``view``
    (``view.program``); None for a run whose trace holds no kernel (off the
    card), for a program without the span recorder, or where the pass
    failed. ``device`` "cpu" runs it on the program's plain paths (the CPU
    tests), the profile then holding no device operation."""
    if not hasattr(view, "program"):
        view.program = None
        on_card = any(o.kind == "kernel" for o in view.ops)
        if view.cell and (on_card or device == "cpu"):
            try:
                view.program = _run_pass(view, device)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                print("program spans: the pass failed; its metrics read nothing",
                      file=sys.stderr, flush=True)
    return view.program


def _run_pass(view, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.burst import make_burst
    from benchmark.run import TRACED_BURSTS, program_config
    from benchmark.trace import from_profiler
    from hmsr_tpu_torch.models import process
    from hmsr_tpu_torch.utils import timing
    if not all(hasattr(timing, f) for f in ("enable", "disable", "collect")):
        return None
    conf, traffic, shape = view.cell["config"], view.cell["traffic"], view.shape
    frames = make_burst(shape["height"], shape["width"], shape["frames"], PASS_SEED, device,
                        conf["noise"]["alpha"], conf["noise"]["beta"],
                        traffic.get("brightness"))
    ref, comps = frames[0], frames[1:]
    if traffic["frames"] == "host":
        ref, comps = ref.cpu().numpy(), comps.cpu().numpy()
    del frames
    base = program_config(conf["config"])

    def burst():
        out, _ = process.process_arrays(ref, comps, copy.deepcopy(base), conf["cfa"],
                                        conf["white_balance"], device=device)
        if traffic["image"] == "host":
            out = out.cpu()
        if device == "cuda":
            torch.cuda.synchronize()

    burst()                             # its tile size may differ from the pool's
    if device == "cuda":
        detach_cupti()
    me = threading.get_native_id()
    timing.collect()
    timing.enable()
    try:
        for _ in range(TRACED_BURSTS):
            burst()
        host = [r for r in timing.collect()["spans"] if r["tid"] == me]
        acts = ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU
        with profile(activities=[acts]) as prof:
            lo = time.time_ns()
            for _ in range(TRACED_BURSTS):
                burst()
            hi = time.time_ns()
    finally:
        timing.disable()
        got = timing.collect()
    ops, _, calls, _ = from_profiler(prof)
    ops = [o for o in ops if o.end_ns > lo and o.start_ns < hi
           and not o.name.startswith(RANGE_PREFIX)]
    # the profiler numbers threads its own way: the caller's is the one that
    # made the runtime calls
    tid = collections.Counter(c.tid for c in calls).most_common(1)[0][0] if calls else 0
    calls = [c for c in calls if c.tid == tid]
    records = [r for r in got["spans"] if r["tid"] == me]
    p = analyse(records, ops, calls, lo, hi, TRACED_BURSTS, tid, host)
    _log(p, view, host_times(records, lo, hi)[0])
    return p


def detach_cupti():
    """Detach CUPTI, which the harness's profiles leave attached: an empty
    trace stopped with ``TEARDOWN_CUPTI=1`` (read by the profiler's kineto
    as a trace stops). Attached, it slows every launch on the host, so that
    the bursts after a profile run up to half again as long on the host
    as before any."""
    from torch.profiler import ProfilerActivity, profile
    old = os.environ.get("TEARDOWN_CUPTI")
    os.environ["TEARDOWN_CUPTI"] = "1"
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            pass
    finally:
        if old is None:
            del os.environ["TEARDOWN_CUPTI"]
        else:
            os.environ["TEARDOWN_CUPTI"] = old


def per_burst_ms(p, ns):
    return ns / 1e6 / p.bursts


def _log(p, view, profiled_host_ns):
    """One line per span name on standard error: host ms (unprofiled, and
    profiled), idle and device ms and launches per burst; and the profile's
    idle share beside the harness's first profile's."""
    whole = p.hi - p.lo
    idle = sum(p.idle_ns.values())
    busy1 = union_ns([(o.start_ns, o.end_ns) for o in view.ops], view.lo, view.hi)
    lines = [f"program spans: {p.bursts} bursts, idle {per_burst_ms(p, idle):.3f} ms/burst "
             f"(share {idle / whole:.4f}; first pass 1 - busy/window "
             f"{1 - busy1 / (view.hi - view.lo):.4f}), wait {per_burst_ms(p, p.wait_ns):.3f}"]
    names = sorted(set(p.host_ns) | set(p.idle_ns) | set(p.device_ns), key=str)
    for n in names:
        lines.append(f"  span {n}: host {per_burst_ms(p, p.host_ns.get(n, 0)):.3f} (profiled "
                     f"{per_burst_ms(p, profiled_host_ns.get(n, 0)):.3f}) idle "
                     f"{per_burst_ms(p, p.idle_ns.get(n, 0)):.3f} device "
                     f"{per_burst_ms(p, p.device_ns.get(n, 0)):.3f} ms, launches "
                     f"{p.launches.get(n, 0) / p.bursts:.1f}, entries "
                     f"{p.entries.get(n, 0) / p.bursts:.1f} per burst")
    print("\n".join(lines), file=sys.stderr, flush=True)


def host_ms(view, name):
    """Host ms per burst inside the spans named ``name``; None where the pass
    did not run or never entered one."""
    p = program_pass(view)
    if p is None or name not in p.host_ns:
        return None
    return per_burst_ms(p, p.host_ns[name])


def idle_ms(view, names):
    """Device-idle ms per burst while a span named in ``names`` was the
    innermost open one; None where the pass did not run or entered none."""
    p = program_pass(view)
    if p is None or not set(names) & set(p.entries):
        return None
    return per_burst_ms(p, sum(p.idle_ns.get(n, 0) for n in names))


def other_spans(view):
    """The names of the pass's spans outside the pipeline's stages: the
    entry's steps, its waits and the pipeline's glue (``process.pipeline``)."""
    p = program_pass(view)
    return [] if p is None else [n for n in p.entries if n not in STAGES]


def wait_ms(view):
    """Host ms per burst inside wait spans; None where the pass did not run."""
    p = program_pass(view)
    return None if p is None else per_burst_ms(p, p.wait_ns)
