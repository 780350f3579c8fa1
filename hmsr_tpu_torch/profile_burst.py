"""Per-stage and per-kernel device time of one warm burst of the main path.

Run from the root of a checkout, on a host with one CUDA card and ``nvcc``::

    python3 -m hmsr_tpu_torch.profile_burst [--height 3000 --width 4000
        --frames 20 --seed 0 --pipeline scan --mode bayer --scale 2
        --out profile.txt]

It makes the ``bench.py`` headline burst on the card
(:mod:`hmsr_tpu_torch.synthetic`), runs the pipeline (``tpu.pipeline``
``--pipeline``: scan, chunked with chunks of 5, fused (K6 and K7's refill
per slab) or vmapped; the others than fused end in K7's border-strip
refill, the ``refill_image`` stage; ``--mode grey``:
``bench.py``'s grey cell, the frames taken as grey images; ``--scale``: the
output scale, with ``bench.py``'s mutations of its x3 and x1 cells at 3
and 1, :data:`SCALE_CELLS`) once to warm up,
:data:`RUNS` times unprofiled (wall seconds, each and the median), and once
under ``torch.profiler`` with a ``record_function`` range around every stage
call of :mod:`hmsr_tpu_torch.models.pipeline`. For the unprofiled runs it
prints each run's wall and the host's share of it: the seconds until the
pipeline call returns, before the closing synchronise (when that is close
to the wall, the host bounds the run), and per stage the median host
milliseconds spent inside its calls (the card's back-pressure on a full
launch queue included). For the profiled run it prints:

- its wall seconds, and the kernel-only device time: the self device time
  of every CUDA kernel row, annotations excluded; the busy share is that
  over the same run's wall time;
- per stage: calls, and the device time of the kernels launched inside
  its range. Torch's kernels are found through the host ops that launch
  them (so the GPU-side copy of each range is not counted again). The
  hand-written kernels are launched through ctypes, outside the profiler's
  op tree: each is added to the stage that launches it (:data:`LAUNCHED_BY`),
  K4's time split between its two stages by launch count;
- the device time and launches of each hand-written kernel (profiler rows
  matched by :func:`kernel_base_name`, so a templated instantiation such as
  ``void name<4>(...)`` counts as ``name``), and the
  heaviest device rows; a hand-written kernel whose wrapper counted
  launches in the profiled run but that shows no device time raises;
- the heaviest host rows by self CPU time (the CUDA runtime calls among
  them: allocations, frees, synchronisations).

The table goes to stdout, and also to ``--out`` when it is given.
"""

import argparse
import os
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .measure import card
from .models import pipeline as P
from .ops import cuda_ica, cuda_merge, cuda_warp
from .synthetic import (BENCH_CELLS, CFA_RGGB, WB, affine_curves, burst_config,
                        burst_snr, make_burst)

STAGES = ("init_alignment", "init_robustness", "compute_grey_image", "align",
          "compute_robustness", "estimate_kernels", "merge_tiled", "merge",
          "_merge_burst_chunked", "merge_burst_fused", "merge_ref_tiled",
          "refill_image")
RUNS = 5                # unprofiled warm runs: the wall spread between runs

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
                "refill_kernel": cuda_merge.refill_groups}
#: stage -> (hand-written kernel, its launches per burst from that stage);
#: None stands for "every launch of the burst". A stage that the profiled
#: run did not enter takes none.
LAUNCHED_BY = {
    "align": (("bm_kernel", None), ("ica_steps_kernel", None), ("ica_fused_kernel", None)),
    "compute_robustness": (("warp_kernel", "n_cmp"),),
    "init_robustness": (("warp_kernel", 2),),
    "merge_tiled": (("merge_kernel", None),),
    "_merge_burst_chunked": (("merge_burst_kernel", None),),
    "merge_burst_fused": (("merge_fused_kernel", None), ("refill_kernel", None)),
    "refill_image": (("refill_kernel", None),),
}


#: stage -> host seconds spent inside its calls since the last clear
HOST_S = {}


def _instrument():
    """Wrap each stage function the pipeline calls in a named range, and
    add the host seconds of each call to :data:`HOST_S`."""
    for name in STAGES:
        fn = getattr(P, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            with record_function("stage::" + _name):
                out = _fn(*a, **k)
            HOST_S[_name] = HOST_S.get(_name, 0.0) + time.perf_counter() - t0
            return out
        setattr(P, name, wrapped)


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


def _kernel_us(e):
    """Device time of the kernels launched under host event ``e``."""
    return (sum(k.duration for k in e.kernels if not k.name.startswith("stage::"))
            + sum(_kernel_us(c) for c in e.cpu_children))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=3000)
    ap.add_argument("--width", type=int, default=4000)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline", choices=("scan", "chunked", "fused", "vmapped"),
                    default="scan")
    ap.add_argument("--mode", choices=("bayer", "grey"), default="bayer")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="also write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_burst needs a CUDA card")
    dev = "cuda"
    smi = card()

    _instrument()
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
    for _ in range(RUNS):
        HOST_S.clear()
        t0 = time.perf_counter()
        pipe(*run_args)
        enqueues.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        host.append(dict(HOST_S))
    for fn in HAND_WRITTEN.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(*run_args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    wrapper_launches = {name: fn.launches for name, fn in HAND_WRITTEN.items()}

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("stage::")]
    busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    stages = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("stage::"):
            n, us = stages.get(e.name[len("stage::"):], (0, 0.0))
            stages[e.name[len("stage::"):]] = (n + 1, us + _kernel_us(e))
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
    for stage, launched in LAUNCHED_BY.items():
        if stage not in stages:
            continue
        for kname, n_from in launched:
            ms, n = ours[kname]
            share = 1.0 if n_from is None else \
                (args.frames - 1 if n_from == "n_cmp" else n_from) / max(n, 1)
            calls, us = stages.get(stage, (0, 0.0))
            stages[stage] = (calls, us + 1e3 * ms * share)
    lines = [smi,
             f"burst {args.frames}x{args.height}x{args.width} x{config.scale}, Ts="
             f"{config.block_matching.tuning.tile_size}, pipeline {args.pipeline}, "
             f"mode {args.mode}",
             f"unprofiled warm runs: {', '.join(f'{w:.4f}' for w in walls)} s, "
             f"median {statistics.median(walls):.4f} s",
             f"  host until the call returns: {', '.join(f'{t:.4f}' for t in enqueues)} "
             f"s, median {statistics.median(enqueues):.4f} s",
             "  host ms inside each stage's calls (median of the runs): " + ", ".join(
                 f"{name} {1e3 * statistics.median(h.get(name, 0.0) for h in host):.2f}"
                 for name in STAGES if any(name in h for h in host)),
             f"profiled run: wall {wall:.4f} s, kernel-only device time "
             f"{busy_ms:.2f} ms over {n_launch} launches, busy share "
             f"{busy_ms / (wall * 1e3):.3f} of the profiled wall",
             "stages (calls, device ms of the kernels inside the range):"]
    lines += [f"  {name:20s} {n:5d} {us / 1e3:10.2f}"
              for name, (n, us) in sorted(stages.items(), key=lambda kv: -kv[1][1])]
    lines.append(f"  {'(sum of stages)':20s}       "
                 f"{sum(us for _, us in stages.values()) / 1e3:10.2f}")
    lines.append("hand-written kernels (device ms, profiler launches, wrapper launches):")
    lines += [f"  {k:20s} {ms:10.2f} {n:6d} {wrapper_launches[k]:6d}"
              for k, (ms, n) in ours.items()]
    lines.append("heaviest device rows (self device ms, calls):")
    for e in sorted(kernels, key=lambda e: -_self_device_us(e))[:30]:
        lines.append(f"  {e.key[:80]:80s} {_self_device_us(e) / 1e3:9.2f} {e.count:6d}")
    lines.append("heaviest host rows (self CPU ms, calls):")
    host = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:15]:
        lines.append(f"  {e.key[:80]:80s} {e.self_cpu_time_total / 1e3:9.2f} {e.count:6d}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
