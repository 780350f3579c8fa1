"""Sets of runs of one cell, one process per run, and the spread of each
metric: what the bounds in ``BENCHMARK.json`` are set from.

    python3 benchmark/sets.py --workload <cell> --seeds 1 2 3 4 5 6 --sets 2
        --seconds <s> [--trace 0|1] [--out chiprun_out/sets_<cell>.jsonl]

Runs ``benchmark/run.py`` for each seed, set after set (the same seeds in
every set), writes each run's record (seed, set, exit code, wall seconds,
the result, the end of its standard error) as a JSON line to ``--out``,
and prints per metric and set the median and the spread: the distance
between the first and third quartile (``statistics.quantiles(n=4)``) as a
share of the median.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    """(median, interquartile range over the median)."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("inf")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    records = []
    for k in range(args.sets):
        for seed in args.seeds:
            t = time.perf_counter()
            p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                                "--workload", args.workload, "--seed", str(seed),
                                "--seconds", str(args.seconds), "--trace", str(args.trace)],
                               cwd=ROOT, capture_output=True, text=True)
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if p.returncode == 0 else None
            except (IndexError, json.JSONDecodeError):
                result = None
            rec = {"workload": args.workload, "set": k, "seed": seed, "rc": p.returncode,
                   "wall_s": time.perf_counter() - t, "result": result,
                   "stderr": p.stderr[-3000:]}
            records.append(rec)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            metrics = (result or {}).get("metrics", {})
            print(f"set {k} seed {seed}: rc {p.returncode}, {rec['wall_s']:.1f} s, correct "
                  f"{(result or {}).get('correct')}, " + ", ".join(
                      f"{n} {m['value']!r}" for n, m in metrics.items()), flush=True)
            if result is None:
                print(p.stderr[-3000:], flush=True)
    names = sorted({n for r in records if r["result"] for n in r["result"]["metrics"]})
    for n in names:
        for k in range(args.sets):
            vals = [r["result"]["metrics"][n]["value"] for r in records
                    if r["set"] == k and r["result"] and n in r["result"]["metrics"]]
            if vals:
                med, sp = spread(vals)
                print(f"{n} set {k}: median {med!r}, spread {sp!r} over {len(vals)} runs",
                      flush=True)
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
