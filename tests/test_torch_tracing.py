"""The port's span recorder (:mod:`hmsr_tpu_torch.utils.timing`): off by
default and free there, spans that nest with their parents and share their
burst's id, the spans ``process_arrays`` records in every pipeline form,
and the profiler's clock shared with the spans' stamps. On the CPU."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import ALPHA, BETA  # noqa: E402

from hmsr_tpu_torch import configs  # noqa: E402
from hmsr_tpu_torch.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu_torch.models import process as P  # noqa: E402
from hmsr_tpu_torch.utils import timing  # noqa: E402

N_FRAMES = 4            # the reference and three compared frames
STAGES = ("align", "robustness", "kernels", "merge")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and its buffer empty."""
    timing.disable()
    timing.collect()
    yield
    timing.disable()
    timing.collect()


def _config(pipeline="scan"):
    c = configs.default_config()
    c.scale = 2
    c.verbose = 0
    c.block_matching.tuning.update(factors=[1, 2], tile_size_factors=[1, 1],
                                   search_radii=[1, 4], metrics=["L1", "L2"])
    c.noise_model.update({"alpha": ALPHA, "beta": BETA})
    c["tpu"] = {"pipeline": pipeline, "merge_chunk": 2}
    return c


def _burst():
    ref, comps, _, _ = make_synthetic_burst(64, 64, n_frames=N_FRAMES, seed=5)
    return ref, comps


def _run(pipeline="scan"):
    ref, comps = _burst()
    return P.process_arrays(ref, comps, _config(pipeline), DEFAULT_CFA, device="cpu")


def test_off_by_default_records_nothing_and_never_enters_record_function(monkeypatch):
    assert not timing.enabled()
    assert timing.span("align") is timing.span("merge") is timing.wait("process.snr")

    def no_range(name):
        raise AssertionError(f"record_function entered for {name}")

    monkeypatch.setattr(timing, "record_function", no_range)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run()
    got = timing.collect()
    assert got["spans"] == [] and got["counts"] == {"entries": {}, "waits": 0}


def test_on_without_a_profiler_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function entered for {name}")

    monkeypatch.setattr(timing, "record_function", no_range)
    timing.enable()
    with timing.span("align"), timing.wait("process.snr"):
        pass
    timing.disable()
    assert [s["name"] for s in timing.collect()["spans"]] == ["align", "process.snr"]


def test_spans_nest_with_their_parents_and_self_time():
    timing.enable()
    with timing.span("process", new_burst=True):
        with timing.span("process.pipeline"):
            with timing.span("align"):
                time.sleep(0.002)
            with timing.span("merge"):
                pass
        with timing.wait("process.snr"):
            time.sleep(0.001)
    got = timing.collect()
    spans = got["spans"]
    assert [s["name"] for s in spans] == ["process", "process.pipeline", "align", "merge",
                                          "process.snr"]
    assert [s["parent"] for s in spans] == [-1, 0, 1, 1, 0]
    assert [s["wait"] for s in spans] == [False, False, False, False, True]
    assert len({s["burst"] for s in spans}) == 1
    assert got["counts"] == {"entries": {n: 1 for n in ("process", "process.pipeline",
                                                        "align", "merge", "process.snr")},
                             "waits": 1}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["tid"] == threading.get_native_id()
        p = spans[s["parent"]] if s["parent"] >= 0 else None
        assert p is None or p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    length = [s["end_ns"] - s["start_ns"] for s in spans]
    own = list(length)                              # self time: less the children's
    for s in spans:
        if s["parent"] >= 0:
            own[s["parent"]] -= s["end_ns"] - s["start_ns"]
    assert own[0] == length[0] - length[1] - length[4]
    assert own[1] == length[1] - length[2] - length[3]
    assert own[2] == length[2] >= 2_000_000 and min(own) >= 0
    assert timing.collect()["spans"] == []          # drained


def test_one_burst_shares_an_id_and_the_next_burst_another():
    timing.enable()
    _run()
    _run()
    spans = timing.collect()["spans"]
    roots = [i for i, s in enumerate(spans) if s["name"] == "process"]
    assert len(roots) == 2 and spans[roots[1]]["burst"] == spans[roots[0]]["burst"] + 1
    for i, s in enumerate(spans):
        assert s["burst"] == spans[roots[0] if i < roots[1] else roots[1]]["burst"]
        assert (s["parent"] == -1) == (i in roots)


@pytest.mark.parametrize("pipeline,merges", [
    ("scan", N_FRAMES - 1 + 2),        # per frame, the reference, the refill
    ("chunked", 1 + 2),                # the chunks' loop, the reference, the refill
    ("fused", 1),                      # K6 and K7 in one
])
def test_process_arrays_records_each_stage(pipeline, merges):
    timing.enable()
    img, _ = _run(pipeline)
    got = timing.collect()
    entries = got["counts"]["entries"]
    for stage in ("align", "robustness", "kernels"):
        assert entries[stage] == N_FRAMES, stage          # each frame and the reference
    assert entries["merge"] == merges
    for name in ("process", "process.upload", "process.noise", "process.pipeline",
                 "process.finishing", "process.orientation"):
        assert entries[name] == 1, name
    waits = [s["name"] for s in got["spans"] if s["wait"]]
    assert waits.count("process.snr") == 1
    assert set(waits) <= {"process.upload", "process.snr", "process.curves",
                          "process.finishing.blur", "process.finishing.ccm"}
    # every stage runs inside the pipeline's span, and no stage inside another
    spans = got["spans"]
    for s in spans:
        if s["name"] in STAGES:
            chain, p = [], s["parent"]
            while p >= 0:
                chain.append(spans[p]["name"])
                p = spans[p]["parent"]
            assert "process.pipeline" in chain and not set(chain) & set(STAGES), chain
    assert tuple(img.shape) == (128, 128, 3)


def test_tracing_leaves_the_image_as_it_was():
    want, _ = _run("fused")
    timing.enable()
    got, _ = _run("fused")
    assert torch.equal(got, want)


def test_profiler_ranges_hold_the_spans_on_one_clock():
    timing.enable()
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):     # the first range's set-up, once
        with timing.span("warm"):
            pass
    timing.collect()
    with torch.profiler.profile(activities=cpu) as prof:
        _run()
    spans = timing.collect()["spans"]
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(timing.RANGE_PREFIX))
    assert [name for _, _, name in events] == [timing.RANGE_PREFIX + s["name"] for s in spans]
    # each range is entered before its span's start is read and left after its
    # end is: on one clock it holds the span (a preempted host only widens
    # it), and starts close by
    slack = 20_000
    gaps = []
    for (t0, t1, name), s in zip(events, spans):
        assert t0 <= s["start_ns"] + slack and s["end_ns"] <= t1 + slack, name
        gaps.append(s["start_ns"] - t0)
    assert sorted(gaps)[len(gaps) // 2] < 1_000_000


def test_recording_switches_off_again_and_drops_what_it_recorded():
    timing.enable()
    with timing.span("kept"):
        pass
    timing.disable()
    with timing.recording():
        assert timing.enabled()
        with timing.span("dropped"):
            pass
    assert not timing.enabled()
    assert [s["name"] for s in timing.collect()["spans"]] == ["kept"]
    timing.enable()
    with timing.recording():
        with timing.span("inner"):
            pass
    assert timing.enabled()                     # on before, on after
    assert [s["name"] for s in timing.collect()["spans"]] == ["inner"]


def test_threads_keep_their_own_parents():
    """More threads than cores, a short switch interval: every span's
    parent is its own thread's enclosing span, and no record is lost."""
    n_threads, depth, rounds = 2 * (os.cpu_count() or 2), 3, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    timing.enable()

    def work(k):
        for _ in range(rounds):
            with timing.span(f"t{k}.0"):
                with timing.span(f"t{k}.1"):
                    with timing.span(f"t{k}.2"):
                        pass

    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = timing.collect()["spans"]
    assert len(spans) == n_threads * depth * rounds
    for s in spans:
        k, level = s["name"][1:].split(".")
        if level == "0":
            assert s["parent"] == -1
        else:
            p = spans[s["parent"]]
            assert p["name"] == f"t{k}.{int(level) - 1}" and p["tid"] == s["tid"]


def test_profile_dir_traces_the_whole_call_with_its_spans(tmp_path):
    c = _config()
    c.tpu["profile_dir"] = str(tmp_path / "prof")
    ref, comps = _burst()
    P.process_arrays(ref, comps, c, DEFAULT_CFA, device="cpu")
    with open(tmp_path / "prof" / "pipeline_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in ("process", "process.upload", "process.noise", "process.snr",
                 "process.pipeline", "align", "merge", "process.finishing",
                 "process.orientation"):
        assert timing.RANGE_PREFIX + name in names, name
    assert not timing.enabled() and timing.collect()["spans"] == []


def test_collect_counts_waits_and_entries():
    timing.enable()
    for _ in range(3):
        with timing.span("merge"):
            with timing.wait("process.finishing.blur"):
                pass
    got = timing.collect()
    assert got["counts"] == {"entries": {"merge": 3, "process.finishing.blur": 3},
                             "waits": 3}
    assert np.all([s["parent"] == 2 * (i // 2) for i, s in enumerate(got["spans"])
                   if s["wait"]])
