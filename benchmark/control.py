"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--program]
        [--out chiprun_out/control_<cell>.jsonl]

For each seed: the burst a run with that seed compares (made again from its
seed), the configuration's plain reference on it, and the control: the same
reference with every tensor it hands from one stage to the next rounded to
bfloat16, the nearest precision below the float32 the configuration states (frames, grey
images, flows, robustness maps, covariances, accumulators, image). With
``--program`` also one call of the program's timed entry on the same burst,
as a run's window makes it. Prints one JSON line per seed and reading:
``{"seed", "side": "program" | "control", "readings": {...}}``.
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.run import load_reference, program_config, resolve  # noqa: E402


def bf16_stage(t):
    import torch
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def readings_for(workload, seed, device="cuda", shape=None, program=False):
    """``{"program": readings or None, "control": readings}`` of ``seed``."""
    import importlib

    import torch

    from benchmark.burst import make_burst, pool_seeds
    from benchmark.compare import readings
    spec = resolve(workload)
    reference_burst = load_reference(spec["reference"])
    conf, traffic = spec["config"], spec["traffic"]
    n_frames, h, w = shape or (conf["frames"], conf["height"], conf["width"])
    seeds = pool_seeds(seed, int(traffic["pool"]))
    args = (h, w, n_frames, seeds[int(seed) % len(seeds)], device, conf["noise"]["alpha"],
            conf["noise"]["beta"], traffic.get("brightness"))
    out = {"program": None}
    with torch.no_grad():
        if program:
            frames = make_burst(*args)
            if traffic["frames"] == "host":
                frames = frames.cpu().numpy()
            proc = importlib.import_module("hmsr_tpu_torch.models.process")
            img, debug = proc.process_arrays(frames[0], frames[1:],
                                             program_config(conf["config"]), conf["cfa"],
                                             conf["white_balance"], device=device)
            prog = (img.cpu(), debug["accumulated_robustness"].cpu())
            del frames, img, debug
        frames = make_burst(*args)
        ref = reference_burst(frames, conf["config"], conf["cfa"], conf["white_balance"])
        if program:
            out["program"] = readings(*prog, *ref)
        ctl = reference_burst(frames, conf["config"], conf["cfa"], conf["white_balance"],
                              stage=bf16_stage)
        out["control"] = readings(*ctl, *ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    lines = []
    for seed in args.seeds:
        t = time.perf_counter()
        got = readings_for(args.workload, seed, program=args.program)
        for side, r in got.items():
            if r is not None:
                lines.append(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                                         "readings": r}))
                print(lines[-1], flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
