"""The benchmark of the port, one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a host with the cards the cell asks for.
Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (``benchmark/configs/<config>.json``: the burst's shape,
the configuration tree as it is run, and the name of its plain reference),
its traffic file
(``benchmark/traffic/<traffic>.json``: where the frames live, where the
image goes, the scene's brightness, the pool size), its limits
(``benchmark/limits/<cell>.json``) and one reader per per-layer metric
(``benchmark/metrics/<metric>.py``).

A run: set-up (imports, the kernel library, a pool of bursts made on the
card from ``--seed``, two warm bursts); then a closed loop of one client
for ``--seconds``: the pool's bursts in turn through
``hmsr_tpu_torch.models.process.process_arrays`` with a fresh copy of the
configuration, each counted done when its image is ready (copied to host
memory for host traffic); then, with ``--trace 1``, a few more bursts
under ``torch.profiler``; then the configuration's plain reference on the
burst whose last image was kept, and the comparison that decides
``correct``. The last line of standard output is the result as one JSON
object.

A configuration file names its reference under ``"reference"``: a module
of ``benchmark/reference/`` that exports ``reference_burst(frames, cfg,
cfa, wb, stage=None)`` (``pipeline``, the fused form at an integer scale,
where the key is absent). A configuration whose form no reference
implements brings one as a new module there, and names it: no file that
exists changes.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT          # the checkout's root, not this folder
# The program's caches on disk, its kernel library (``build/hmsr_kernels``) and
# its noise curves (``build/noise_cache``), lie inside the checkout already; it
# uses no Triton, no torch extension and no ``torch.compile``.

from benchmark.guard import banned_loaded  # noqa: E402

#: bursts profiled after the window with ``--trace 1``
TRACED_BURSTS = 3
PROGRAM = "hmsr_tpu_torch.models.process"


class NoCard(RuntimeError):
    pass


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def resolve(workload):
    """The cell's entry, its configuration and traffic files, its limits, and
    its end-to-end and per-layer metric entries, from ``BENCHMARK.json``."""
    bench = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {', '.join(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(m):
        return workload in m.get("workloads", [workload])

    config = load_json(conf["file"])
    return dict(cell=cell, config=config, reference=config.get("reference", "pipeline"),
                traffic=load_json("benchmark", "traffic", cell["traffic"] + ".json"),
                limits=load_json("benchmark", "limits", workload + ".json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def load_reference(name):
    """``reference_burst`` of the reference module ``name``
    (``benchmark/reference/<name>.py``)."""
    return importlib.import_module("benchmark.reference." + name).reference_burst


def load_reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(tree):
    """The program's configuration tree: its defaults overlaid with the
    configuration file's tree, as a user builds it."""
    from hmsr_tpu_torch.configs import default_config, merge
    return merge(default_config(), tree)


class Spans:
    """Named host spans around calls into the program, both in the
    profiler's timeline (``bench::<name>``) and as host seconds summed per
    name. Wraps module functions by name and puts them back on
    :meth:`restore`; a name the program no longer has is left out."""

    def __init__(self):
        self.host, self.missing, self._undo = {}, [], []

    @contextlib.contextmanager
    def span(self, name):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function("bench::" + name):
            yield
        self.host[name] = self.host.get(name, 0.0) + time.perf_counter() - t0

    def timed(self, fn, name):
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return wrapped

    def wrap(self, entry):
        """``entry``: {"module", "name", "span", "wrap": "call" | "result"};
        "result" times the callable that the function returns."""
        try:
            mod = importlib.import_module(entry["module"])
        except ImportError:
            mod = None
        fn = getattr(mod, entry["name"], None)
        if fn is None:
            self.missing.append(f"{entry['module']}.{entry['name']}")
            return
        if entry.get("wrap", "call") == "result":
            def new(*a, _fn=fn, **k):
                return self.timed(_fn(*a, **k), entry["span"])
        else:
            new = self.timed(fn, entry["span"])
        setattr(mod, entry["name"], new)
        self._undo.append((mod, entry["name"], fn))

    def restore(self):
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo.clear()


def affine_tile_size(ref, alpha, beta):
    """The tile size the SNR rule gives the burst under the affine noise
    model (for counting work; each side works it out for itself)."""
    from benchmark.reference.noise import snr_settings
    b = float(ref.double().mean())
    return snr_settings(b / max((alpha * b + beta) ** 0.5, 1e-12))["tile_size"]


def run(workload, seed, seconds, trace, device="cuda", shape=None, log=None):
    """One run of ``workload``; returns the result object. ``shape``
    (frames, height, width) replaces the configuration's burst size (the
    CPU tests' small runs); ``device`` "cpu" runs the program's plain paths
    and skips every device measurement."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec = resolve(workload)
    conf, traffic = spec["config"], spec["traffic"]
    import torch
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < int(spec["cell"]["chips"])):
        raise NoCard(f"the cell needs {spec['cell']['chips']} CUDA card(s); "
                     f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    split = {"torch_s": time.perf_counter() - T_START}
    if on_card:
        from benchmark.peaks import card
        log(f"card: {card()}")

    t = time.perf_counter()
    program = importlib.import_module(PROGRAM)
    _guard()
    if on_card:
        importlib.import_module("hmsr_tpu_torch.ops._build").library()
    split["program_s"] = time.perf_counter() - t

    from benchmark.burst import make_burst, pool_seeds
    from benchmark.trace import percentile_sorted
    n_frames, h, w = shape or (conf["frames"], conf["height"], conf["width"])
    alpha, beta = conf["noise"]["alpha"], conf["noise"]["beta"]
    brightness = traffic.get("brightness")
    seeds = pool_seeds(seed, int(traffic["pool"]))
    keep = int(seed) % len(seeds)       # the burst whose last image is compared
    t = time.perf_counter()
    pool = []
    for s in seeds:
        frames = make_burst(h, w, n_frames, s, device, alpha, beta, brightness)
        if traffic["frames"] == "host":
            frames = frames.cpu().numpy()
        pool.append((frames[0], frames[1:]))
    if on_card:
        torch.cuda.synchronize()
    split["bursts_s"] = time.perf_counter() - t

    base = program_config(conf["config"])
    cfa, wb = conf["cfa"], conf["white_balance"]
    to_host = traffic["image"] == "host"

    ran = []                        # the tree of the last call, as the program set it

    def burst(j):
        ran[:] = [copy.deepcopy(base)]
        out, debug = program.process_arrays(pool[j][0], pool[j][1], ran[0], cfa, wb,
                                            device=device)
        if to_host:
            out = out.cpu()
        if on_card:
            torch.cuda.synchronize()
        return out, debug.get("accumulated_robustness")

    # the noise curves the first call would draw, timed apart where the
    # program still has the function (its cache then serves every call)
    mc = getattr(importlib.import_module("hmsr_tpu_torch.noise"), "run_fast_MC", None)
    if mc is not None:
        t = time.perf_counter()
        mc(alpha, beta, device=device)
        split["curves_s"] = time.perf_counter() - t
    for k in range(2):              # warm-up: every shape the window uses
        t = time.perf_counter()
        burst(k % len(pool))
        split[f"warm{k + 1}_s"] = time.perf_counter() - t
    form = importlib.import_module("hmsr_tpu_torch.models.pipeline").pipeline_form(ran[0])
    log(f"the program ran the {form} form at tile size "
        f"{ran[0].block_matching.tuning.tile_size}, scale {ran[0].scale}")

    spans = Spans()
    readers = {m["name"]: load_reader(m["name"]) for m in spec["per_layer"]} if trace else {}
    if trace:
        wanted = {}
        for r in readers.values():
            for entry in getattr(r, "SPANS", ()):
                wanted.setdefault((entry["module"], entry["name"]), entry)
        for entry in wanted.values():
            spans.wrap(entry)
        call = spans.timed(burst, "burst")
    else:
        call = burst
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_START
        lat, failed, held, j = [], 0, None, 0
        t_open = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                img, acc = call(j)
                if j == keep:
                    held = (img, acc)
                del img, acc
            except Exception:           # a failed burst counts, and the loop goes on
                failed += 1
                traceback.print_exc(file=sys.stderr)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            j = (j + 1) % len(pool)
            if t1 - t_open >= seconds and len(lat) >= len(pool):
                break
        window_s = t1 - t_open
        # the window's host spans alone: the profiled bursts below add to them
        host_s, done = dict(spans.host), len(lat) - failed
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if trace:
            cell_shape = dict(frames=n_frames, height=h, width=w, tile_size=affine_tile_size(
                torch.as_tensor(pool[0][0]), alpha, beta))
            view, dev_info = _profile(call, len(pool), on_card)
            view.host, view.window_bursts, view.latencies = host_s, done, list(lat)
            view.cell, view.shape = dict(config=conf, traffic=traffic), cell_shape
    finally:
        spans.restore()
    _guard()

    metrics = {}
    if not trace:
        values = {"burst_s": window_s / max(done, 1), "peak_gib": peak / 2**30,
                  "setup_s": setup_s, "burst_p75_s": percentile_sorted(lat, 0.75)}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    log(f"setup {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"window {window_s:.3f} s, {len(lat)} bursts ({failed} failed), latency min "
        f"{min(lat):.4f} median {percentile_sorted(lat, 0.5):.4f} max {max(lat):.4f} s, "
        f"peak {peak / 2**30:.4f} GiB")

    result = {"correct": False, "attempted": len(lat), "failed": failed, "metrics": metrics,
              "device": _device(torch, on_card, peak)}
    if trace:
        for name, r in readers.items():
            v = r.read(view)
            if v is None:
                log(f"{name}: nothing to read")
            else:
                m = next(m for m in spec["per_layer"] if m["name"] == name)
                metrics[name] = {"value": v, "unit": m["unit"]}
        if spans.missing:
            log("not in the program any more: " + ", ".join(spans.missing))
        result["device"].update(busy_s=dev_info["busy_s"], window_s=dev_info["window_s"])
        result["breakdown"] = dev_info["breakdown"]
        log(f"trace: {dev_info['n_ops']} device ops, {dev_info['unmatched']} without their "
            f"host event, {dev_info['unattributed']} outside every span "
            f"{dev_info['unattributed_names']}")

    # the reference, once the program's state is freed
    del pool, call
    prog_img, prog_acc = held if held is not None else (None, None)
    held = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    result["correct"], result["checks"] = _check(spec, seeds[keep], (n_frames, h, w), device,
                                                 prog_img, prog_acc, log)
    return result


def _profile(call, n_pool, on_card):
    """Two profiles of :data:`TRACED_BURSTS` bursts each: one of the device
    alone, whose host runs at its unprofiled pace (busy and idle times, the
    operations, the copies), and one that also records the host's
    operators (slower on the host) for the attribution of device time to
    spans. Returns the :class:`benchmark.trace.View` and the device block's
    and the breakdown's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import (View, attribute, from_profiler, idle_gaps, top_ops,
                                 union_ns)
    dev_acts = [ProfilerActivity.CUDA] if on_card else []
    with profile(activities=dev_acts or [ProfilerActivity.CPU]) as prof:
        lo = time.time_ns()             # the profiler's clock (checked within 0.1 ms)
        for k in range(TRACED_BURSTS):
            call(k % n_pool)
        hi = time.time_ns()
    ops = [o for o in from_profiler(prof)[0] if o.end_ns > lo and o.start_ns < hi]
    with profile(activities=[ProfilerActivity.CPU] + dev_acts) as prof:
        for k in range(TRACED_BURSTS):
            call(k % n_pool)
    d_ops, operators, calls, sp = from_profiler(prof)
    bursts = sorted((s for s in sp if s.name == "burst"), key=lambda s: s.start_ns)
    b_lo, b_hi = bursts[0].start_ns, bursts[-1].end_ns
    att = attribute([o for o in d_ops if o.end_ns > b_lo and o.start_ns < b_hi], operators, sp,
                    calls)
    view = View(ops, TRACED_BURSTS, lo, hi, att, sp, len(bursts))
    info = dict(busy_s=union_ns([(o.start_ns, o.end_ns) for o in ops], lo, hi) / 1e9,
                window_s=(hi - lo) / 1e9,
                breakdown={"device_ops": top_ops(ops),
                           "idle_gaps": idle_gaps(att.ops, sp, b_lo, b_hi)},
                n_ops=len(att.ops), unmatched=att.unmatched,
                unattributed_names=top_ops(
                    [o for o, n in zip(att.ops, att.span_of) if n is None], top=5),
                unattributed=sum(1 for n in att.span_of if n is None))
    return view, info


def _guard():
    found = banned_loaded(sys.modules)
    if found:
        raise RuntimeError(f"modules the benchmark may not load are loaded: {found}")


def _device(torch, on_card, peak):
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def _check(spec, burst_seed, shape, device, prog_img, prog_acc, log):
    """The configuration's reference on the kept burst, made again from its
    seed, and the comparison; prints each number beside its limit last on
    stderr."""
    import torch

    from benchmark.burst import make_burst
    from benchmark.compare import judge, readings
    conf, traffic = spec["config"], spec["traffic"]
    reference_burst = load_reference(spec["reference"])
    t = time.perf_counter()
    n_frames, h, w = shape
    frames = make_burst(h, w, n_frames, burst_seed, device, conf["noise"]["alpha"],
                        conf["noise"]["beta"], traffic.get("brightness"))
    with torch.no_grad():
        ref_img, ref_acc = reference_burst(frames, conf["config"], conf["cfa"],
                                           conf["white_balance"])
        del frames
        values = readings(prog_img, prog_acc, ref_img, ref_acc)
    ok, checks = judge(values, spec["limits"])
    log(f"reference {time.perf_counter() - t:.3f} s; readings " + ", ".join(
        f"{k} {v!r}" for k, v in values.items()))
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return ok, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc(file=sys.stderr)
        print("no result: the run failed", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
