"""Per-stage and per-kernel device time of one warm burst of the main path.

Run from the root of a checkout, on a host with one CUDA card and ``nvcc``::

    python3 -m hmsr_tpu_torch.profile_burst [--height 3000 --width 4000
        --frames 20 --seed 0 --pipeline scan --mode bayer --scale 2
        --out profile.txt]

It makes the ``bench.py`` headline burst on the card
(:mod:`hmsr_tpu_torch.synthetic`), runs the pipeline (``tpu.pipeline``
``--pipeline``: scan, chunked with chunks of 5, or fused (K6 and K7's refill
per slab); ``--mode grey``: ``bench.py``'s grey cell, the frames
taken as grey images; ``--scale``: the output scale, with ``bench.py``'s
mutations of its x3 and x1 cells at 3 and 1, :data:`SCALE_CELLS`) once to
warm up, :data:`RUNS` times unprofiled with the program's span recorder on
(:mod:`hmsr_tpu_torch.utils.timing`), and once under ``torch.profiler``. The
stages are the program's own spans (``align``, ``robustness``, ``kernels``,
``merge``); what runs in the pipeline outside them is its glue. For the
unprofiled runs it prints each run's wall and the host's share of it: the
seconds until the pipeline call returns, before the closing synchronise
(when that is close to the wall, the host bounds the run), and per stage
the median host milliseconds inside its spans (the card's back-pressure on
a full launch queue included). For the profiled run it prints:

- its wall seconds, and the kernel-only device time: the self device time
  of every CUDA kernel row, the spans' device-side copies excluded; the
  busy share is that over the same run's wall time;
- per stage: spans entered, kernels, and the device time of the operations
  launched inside its ``hmsr::`` ranges: each device operation goes to the
  innermost range open on its thread when the operator it is linked to
  started or, for a kernel launched through ctypes outside any operator,
  when its CUDA runtime call did;
- the device time and launches of each hand-written kernel (profiler rows
  matched by :func:`kernel_base_name`, so a templated instantiation such as
  ``void name<4>(...)`` counts as ``name``), and the heaviest device rows; a
  hand-written kernel whose wrapper counted launches in the profiled run
  but that shows no device time raises;
- the heaviest host rows by self CPU time (the CUDA runtime calls among
  them: allocations, frees, synchronisations).

The table goes to stdout, and also to ``--out`` when it is given.
"""

import argparse
import bisect
import os
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .measure import card
from .models import pipeline as P
from .ops import cuda_estimate, cuda_ica, cuda_merge, cuda_robustness, cuda_warp
from .synthetic import (BENCH_CELLS, CFA_RGGB, WB, affine_curves, burst_config,
                        burst_snr, make_burst)
from .utils import timing

RUNS = 5                # unprofiled warm runs: the wall spread between runs
GLUE = "(glue)"         # the pipeline outside every stage span

#: scales whose ``bench.py`` cell mutates more than the scale
#: (:data:`hmsr_tpu_torch.synthetic.BENCH_CELLS`)
SCALE_CELLS = {1.0: BENCH_CELLS["x1"], 3.0: BENCH_CELLS["x3"]}
#: hand-written kernel -> the wrapper that launches it (and counts launches)
HAND_WRITTEN = {"bm_kernel": cuda_ica.block_match, "ica_steps_kernel": cuda_ica.ica_steps,
                "ica_fused_kernel": cuda_ica.ica_fused,
                "warp_kernel": cuda_warp.upscale_warp,
                "merge_kernel": cuda_merge.merge_accumulate,
                "merge_burst_kernel": cuda_merge.merge_burst_accumulate,
                "merge_fused_kernel": cuda_merge.merge_fused_accumulate,
                "refill_kernel": cuda_merge.refill_groups,
                "robustness_kernel": cuda_robustness.robustness_fused,
                "gather_merge_kernel": cuda_merge.gather_merge_accumulate,
                "estimate_kernel": cuda_estimate.estimate_kernels_fused}


def kernel_base_name(key):
    """The bare function name of a profiler kernel row: template arguments,
    the parameter list, the return type and namespaces stripped
    (``void ns::merge_kernel<4>(float const*, int)`` -> ``merge_kernel``)."""
    out, depth = [], 0
    for ch in key:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    words = "".join(out).split()
    return words[-1].split("::")[-1] if words else ""


def _self_device_us(e):
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


def stage_device(prof):
    """Per innermost ``hmsr::`` range (:data:`GLUE` for none): ``(kernels,
    device ns)`` of the device operations launched inside it, each placed by
    its linked operator or, failing that, by its runtime call."""
    ops, host, ranges = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(timing.RANGE_PREFIX):
                ops.append(e)
            continue
        if name.startswith(timing.RANGE_PREFIX):
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), name[len(timing.RANGE_PREFIX):]))
        if name.startswith("cu") or e.linked_correlation_id() == 0:
            host[("call" if name.startswith("cu") else "op", e.correlation_id())] = e
    for rs in ranges.values():
        rs.sort()
    out = {}
    for o in ops:
        h = host.get(("op", o.linked_correlation_id())) if o.linked_correlation_id() else None
        h = h or host.get(("call", o.correlation_id()))
        name = GLUE
        if h is not None:
            rs, ts = ranges.get(h.start_thread_id(), []), h.start_ns()
            for s, e, n in reversed(rs[:bisect.bisect_right(rs, (ts, float("inf"), ""))]):
                if s <= ts < e:         # the latest-started range holding it is innermost
                    name = n
                    break
        k, ns = out.get(name, (0, 0))
        out[name] = (k + (not o.name().lower().startswith(("memcpy", "memset"))),
                     ns + o.duration_ns())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=3000)
    ap.add_argument("--width", type=int, default=4000)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline", choices=("scan", "chunked", "fused"),
                    default="scan")
    ap.add_argument("--mode", choices=("bayer", "grey"), default="bayer")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="also write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_burst needs a CUDA card")
    dev = "cuda"
    smi = card()

    frames = make_burst(args.height, args.width, args.frames, args.seed, dev)
    std, diff = affine_curves()
    scale = int(args.scale) if args.scale == int(args.scale) else args.scale
    config = burst_config((args.height, args.width), burst_snr(frames[0], std), scale)
    SCALE_CELLS.get(float(scale), lambda c: None)(config)
    config["tpu"] = {"pipeline": args.pipeline, "merge_chunk": 5}
    config.mode = args.mode
    pipe = P.make_pipeline(config, CFA_RGGB, WB, dev)
    run_args = (frames[0], frames[1:], torch.as_tensor(std, device=dev),
                torch.as_tensor(diff, device=dev))

    pipe(*run_args)
    torch.cuda.synchronize()
    walls, enqueues, host = [], [], []
    with timing.recording():
        for _ in range(RUNS):
            timing.collect()
            t0 = time.perf_counter()
            pipe(*run_args)
            enqueues.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            ms = {}
            for s in timing.collect()["spans"]:
                ms[s["name"]] = ms.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e6
            ms[GLUE] = 1e3 * enqueues[-1] - sum(ms.values())
            host.append(ms)
    for fn in HAND_WRITTEN.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            timing.recording():
        t0 = time.perf_counter()
        pipe(*run_args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        entries = timing.collect()["counts"]["entries"]
    wrapper_launches = {name: fn.launches for name, fn in HAND_WRITTEN.items()}

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith(timing.RANGE_PREFIX)]
    busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    stages = stage_device(prof)
    ours = {name: (0.0, 0) for name in HAND_WRITTEN}
    for e in kernels:
        base = kernel_base_name(e.key)
        if base in ours:
            ms, n = ours[base]
            ours[base] = (ms + _self_device_us(e) / 1e3, n + e.count)
    missing = [k for k, n in wrapper_launches.items() if n and not ours[k][0] > 0]
    if missing:
        raise RuntimeError(f"hand-written kernels launched {wrapper_launches} but without "
                           f"device time in the profile: {missing}")
    lines = [smi,
             f"burst {args.frames}x{args.height}x{args.width} x{config.scale}, Ts="
             f"{config.block_matching.tuning.tile_size}, pipeline {args.pipeline}, "
             f"mode {args.mode}",
             f"unprofiled warm runs: {', '.join(f'{w:.4f}' for w in walls)} s, "
             f"median {statistics.median(walls):.4f} s",
             f"  host until the call returns: {', '.join(f'{t:.4f}' for t in enqueues)} "
             f"s, median {statistics.median(enqueues):.4f} s",
             "  host ms inside each stage's spans (median of the runs): " + ", ".join(
                 f"{name} {statistics.median(h.get(name, 0.0) for h in host):.2f}"
                 for name in sorted(host[0])),
             f"profiled run: wall {wall:.4f} s, kernel-only device time "
             f"{busy_ms:.2f} ms over {n_launch} launches, busy share "
             f"{busy_ms / (wall * 1e3):.3f} of the profiled wall",
             "stages (spans entered, kernels, device ms of the operations launched in "
             "their ranges):"]
    lines += [f"  {name:12s} {entries.get(name, 0):5d} {k:6d} {ns / 1e6:10.2f}"
              for name, (k, ns) in sorted(stages.items(), key=lambda kv: -kv[1][1])]
    lines.append(f"  {'(sum)':12s}       {sum(k for k, _ in stages.values()):6d} "
                 f"{sum(ns for _, ns in stages.values()) / 1e6:10.2f}")
    lines.append("hand-written kernels (device ms, profiler launches, wrapper launches):")
    lines += [f"  {k:20s} {ms:10.2f} {n:6d} {wrapper_launches[k]:6d}"
              for k, (ms, n) in ours.items()]
    lines.append("heaviest device rows (self device ms, calls):")
    for e in sorted(kernels, key=lambda e: -_self_device_us(e))[:30]:
        lines.append(f"  {e.key[:80]:80s} {_self_device_us(e) / 1e3:9.2f} {e.count:6d}")
    lines.append("heaviest host rows (self CPU ms, calls):")
    cpu_rows = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(cpu_rows, key=lambda e: -e.self_cpu_time_total)[:15]:
        lines.append(f"  {e.key[:80]:80s} {e.self_cpu_time_total / 1e3:9.2f} {e.count:6d}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
