"""The harness on the CPU: ``BENCHMARK.json`` and the files it names, the
result line, the traffic generator, the import guard, the plain reference
against the program, the lower-precision control, and the faults that
``correct`` has to catch. The runs here use small bursts; the cells' own
sizes run only on the card."""

import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run as R
from benchmark.burst import make_burst, pool_seeds
from benchmark.guard import banned_loaded

ROOT = R.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
#: a small burst the program's plain paths run quickly (256 px holds every
#: pyramid level's tile at 16-px tiles, 1024 px at 64-px tiles)
SMALL = {"x2_dark64_device": (4, 1024, 1024)}
#: the tile size the SNR rule gives a cell's scene, where it is not 16 px,
#: and the form the program runs, where it is not the fused one
TILE = {"x2_dark64_device": 64}
FORM = {"x1_5_device": "scan"}


def small(cell):
    return SMALL.get(cell, (4, 256, 256))


def cpu_run(cell, seed=12345678901, log=lambda *a: None, **kw):
    return R.run(cell, seed, 0.0, False, device="cpu", shape=small(cell), log=log, **kw)


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and not c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"]) and layers
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    spec = R.resolve(cell)
    conf, traffic = spec["config"], spec["traffic"]
    assert conf["name"] == spec["cell"]["config"]
    assert traffic["frames"] in ("host", "device") and traffic["image"] in ("host", "device")
    assert int(traffic["pool"]) >= 2
    assert set(spec["limits"]) and all(v > 0 for v in spec["limits"].values())
    for m in spec["per_layer"]:
        assert callable(R.load_reader(m["name"]).read)
    assert callable(R.load_reference(spec["reference"]))
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2


def test_generator_reproduces_from_a_seed():
    big = 2**31 + 12345
    a = make_burst(64, 96, 3, big, "cpu", 1.8e-4, 3e-6)
    b = make_burst(64, 96, 3, big, "cpu", 1.8e-4, 3e-6)
    c = make_burst(64, 96, 3, big + 1, "cpu", 1.8e-4, 3e-6)
    assert a.shape == (3, 64, 96) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 1
    dark = make_burst(64, 96, 3, big, "cpu", 1.8e-4, 3e-6, brightness=0.07)
    assert float(dark.mean()) < 0.2 < float(a.mean())
    assert pool_seeds(big, 2) == pool_seeds(big, 2) and len(set(pool_seeds(big, 4))) == 4
    assert pool_seeds(big, 2) != pool_seeds(big + 1, 2)


def test_guard_compares_whole_top_level_names():
    assert banned_loaded(["hmsr_tpu_torch", "hmsr_tpu_torch.models", "jaxtyping"]) == []
    assert banned_loaded(["hmsr_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "hmsr_tpu", "jax", "jaxlib"]


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return ast.literal_eval(out.strip().splitlines()[-1])


def test_nothing_the_benchmark_runs_loads_jax():
    mods = _loaded_after("import benchmark.run, benchmark.reference, benchmark.control, "
                         "benchmark.compare, benchmark.trace\n"
                         "import hmsr_tpu_torch.models.process, hmsr_tpu_torch.ops._build")
    assert banned_loaded(mods) == []


def test_reference_imports_nothing_of_the_program():
    refs = sorted({R.resolve(c)["reference"] for c in CELLS})
    assert {"pipeline", "scan"} <= set(refs)
    mods = _loaded_after("\n".join(f"import benchmark.reference.{r}" for r in refs))
    assert not [m for m in mods if m.split(".")[0] in ("hmsr_tpu_torch", "hmsr_tpu", "jax")]
    src = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(src):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(src, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    tops = [(node.module or "").split(".")[0]] if not node.level else []
                else:
                    continue
                assert not set(tops) & {"hmsr_tpu_torch", "hmsr_tpu", "jax", "benchmark"}, f


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_and_reference_agree_with_the_program(cell):
    said = []
    res = cpu_run(cell, log=lambda *a: said.append(" ".join(map(str, a))))
    assert (f"the program ran the {FORM.get(cell, 'fused')} form at tile size "
            f"{TILE.get(cell, 16)}") in "\n".join(said)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    e2e = {m["name"] for m in R.resolve(cell)["end_to_end"]}
    assert set(res["metrics"]) == e2e
    assert res["attempted"] >= 2 and res["failed"] == 0
    # on the CPU the program runs the plain twins of its kernels: the reference
    # agrees but for the finishing blur's summation order
    assert res["checks"]["image_rel_rms"]["value"] < 1e-6
    assert res["checks"]["accrob_rel_rms"]["value"] < 1e-6
    assert res["correct"] is True
    assert list(res["checks"]) == list(R.resolve(cell)["limits"])


def test_traced_result_line():
    res = R.run("x2_host", 987654321987, 0.0, True, device="cpu", shape=small("x2_host"),
                log=lambda *a: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    # the CPU trace holds no device operation: the device readers read nothing,
    # the host spans' and the window's readers do
    assert set(res["metrics"]) == {"entry_self_ms", "pipeline_host_ms", "burst_min_s"}
    assert res["metrics"]["burst_min_s"]["value"] > 0
    assert res["metrics"]["pipeline_host_ms"]["value"] > 0 and res["correct"] is True


def test_profiled_bursts_stay_out_of_the_host_spans(monkeypatch):
    # the bursts profiled after the window are slowed down here; the host
    # spans' readers divide by the window's bursts, so they must not see them
    proc = __import__("hmsr_tpu_torch.models.process", fromlist=["process_arrays"])
    orig, profiling, pause = proc.process_arrays, [], 1.0

    def slowed(*a, **k):
        if profiling:
            time.sleep(pause)
        return orig(*a, **k)

    def profile(*a, _orig=R._profile, **k):
        profiling.append(True)
        return _orig(*a, **k)

    monkeypatch.setattr(proc, "process_arrays", slowed)
    monkeypatch.setattr(R, "_profile", profile)
    res = R.run("x2_host", 246813579246, 0.0, True, device="cpu", shape=small("x2_host"),
                log=lambda *a: None)
    assert profiling and res["attempted"] == 2
    # leaked, the six profiled bursts would add 6 * 1000 / 2 ms to each burst
    assert res["metrics"]["entry_self_ms"]["value"] < 1e3 * pause / 2


@pytest.mark.parametrize("cell", ["x2_host", "x2_dark64_device", "x1_5_device"])
def test_lower_precision_control_is_not_correct(cell):
    from benchmark.compare import judge
    from benchmark.control import readings_for
    got = readings_for(cell, 424242424242, device="cpu", shape=small(cell))
    ok, checks = judge(got["control"], R.resolve(cell)["limits"])
    assert not ok, checks


def _fault(monkeypatch, kind):
    proc = __import__("hmsr_tpu_torch.models.process", fromlist=["process_arrays"])
    orig = proc.process_arrays
    last = {}

    def broken(ref, comps, *a, **k):
        if kind == "half":              # half of the compared frames left out
            comps = comps[: len(comps) // 2]
        img, debug = orig(ref, comps, *a, **k)
        if kind == "stale":             # the state of the previous call returned
            img, debug, last["out"] = (*last.get("out", (img, debug)), (img, debug))
        if kind == "altered":           # the answer altered where it is produced
            img = img * 1.01
        return img, debug

    monkeypatch.setattr(proc, "process_arrays", broken)


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_faults_are_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    res = cpu_run("x2_host", seed=55555555555)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("kind", ["half", "altered"])
def test_faults_are_not_correct_at_x1_5(monkeypatch, kind):
    _fault(monkeypatch, kind)
    res = cpu_run("x1_5_device", seed=66666666666)
    assert res["correct"] is False, res["checks"]


def _tree(set_=(), **tpu):
    """The x1.5 configuration's tree with the dotted keys of ``set_`` set and
    ``tpu`` merged into its ``tpu`` group."""
    from benchmark.reference.pipeline import _get
    tree = json.loads(json.dumps(R.resolve("x1_5_device")["config"]["config"]))
    tree["tpu"].update(tpu)
    for key, value in set_:
        *head, last = key.split(".")
        (_get(tree, ".".join(head)) if head else tree)[last] = value
    return tree


@pytest.mark.parametrize("named, set_, tpu", [
    ("mode", [("mode", "grey")], {}),
    ("merging.kernel", [("merging.kernel", "iso")], {}),
    ("tpu.pipeline", [("scale", 2)], {}),                      # the fused form
    ("tpu.merge_impl", [("scale", 2)], {"pipeline": "scan"}),  # scan with K5
    ("tpu.pipeline", [], {"pipeline": "chunked"}),
    ("tpu.pipeline", [], {"pipeline": "vmapped"}),
    ("tpu.merge_impl", [], {"merge_impl": "tiled"})])
def test_scan_reference_refuses_what_it_does_not_implement(named, set_, tpu):
    from benchmark.reference.scan import check_supported
    with pytest.raises(ValueError, match=re.escape(named + "=")):
        check_supported(_tree(set_, **tpu))


def test_scan_reference_takes_the_gather_merge_at_any_scale():
    from benchmark.reference.scan import check_supported
    check_supported(_tree())
    check_supported(_tree(pipeline="scan", merge_impl="gather"))
    check_supported(_tree([("scale", 2)], pipeline="fused", merge_impl="gather"))


def test_a_configuration_brings_its_reference_as_new_files(tmp_path):
    # a copy of the harness to which a configuration, its cell and its
    # reference module are added as new files, and BENCHMARK.json's lists grow
    subprocess.run(["cp", "-r", os.path.join(ROOT, "benchmark"), str(tmp_path / "benchmark")],
                   check=True)
    bench = json.loads(json.dumps(BENCH))
    conf = R.load_json("benchmark", "configs", "burst20_12mp_x2.json")
    conf.update(name="toy", reference="toy_ref")
    (tmp_path / "benchmark" / "configs" / "toy.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark" / "limits" / "toy_cell.json").write_text('{"image_rel_rms": 1}')
    (tmp_path / "benchmark" / "reference" / "toy_ref.py").write_text(
        "def reference_burst(frames, cfg, cfa, wb, stage=None):\n"
        "    return 'toy', cfg['scale']\n")
    bench["configs"].append(dict(bench["configs"][0], name="toy",
                                 file="benchmark/configs/toy.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="toy_cell", config="toy"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from benchmark import run as R\n"
            "spec = R.resolve('toy_cell')\n"
            "print(spec['reference'], R.load_reference(spec['reference'])(None, spec['config']"
            "['config'], None, None), R.resolve('x2_host')['reference'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["toy_ref", "('toy',", "2)", "pipeline"]


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "x2_host", "--seed", "1", "--seconds", "1"]) != 0


def test_without_the_program_no_result(tmp_path):
    for rel in ["BENCHMARK.json"]:
        (tmp_path / rel).write_text(open(os.path.join(ROOT, rel)).read())
    subprocess.run(["cp", "-r", os.path.join(ROOT, "benchmark"), str(tmp_path / "benchmark")],
                   check=True)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "x2_host", "--seed",
                        "1", "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_small_run_on_the_card(cuda):
    res = R.run("x2_device", 31415926535, 1.0, True, device=cuda, shape=(4, 512, 512),
                log=lambda *a: None)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["metrics"]["launches"]["value"] > 0
    assert 0 < res["metrics"]["idle_share"]["value"] < 100

