"""The program's spans over a device trace (:mod:`benchmark.program_spans`)
on a made-up trace: host, idle and device time per span, the idle parts
adding up to the whole, the readers of the new metrics, and the pass on
the CPU."""

import pytest

from benchmark import program_spans as PS
from benchmark.run import load_reader
from benchmark.trace import DeviceOp, Launch, View, attribute, union_ns

T = 3           # the calling thread in the profile

# one burst [0, 200]: process [10, 190] > process.upload (wait) [12, 30],
# process.snr (wait) [32, 40], process.pipeline [40, 170] > align [45, 80],
# robustness [80, 100], kernels [100, 120], merge [130, 160]; then
# process.finishing [170, 185]
RECORDS = [dict(name=n, start_ns=s, end_ns=e, parent=-1, burst=1, tid=99, wait=w)
           for n, s, e, w in [("process", 10, 190, False), ("process.upload", 12, 30, True),
                              ("process.snr", 32, 40, True),
                              ("process.pipeline", 40, 170, False), ("align", 45, 80, False),
                              ("robustness", 80, 100, False), ("kernels", 100, 120, False),
                              ("merge", 130, 160, False), ("process.finishing", 170, 185, False)]]
# device operations and the runtime calls that launched them (CUPTI id, start)
OPS = [DeviceOp("Memcpy HtoD", "memcpy", 14, 28, 1), DeviceOp("k_align", "kernel", 50, 70, 2),
       DeviceOp("k_rob", "kernel", 85, 110, 3), DeviceOp("k_cov", "kernel", 110, 118, 4),
       DeviceOp("merge_fused_kernel", "kernel", 135, 175, 5),
       DeviceOp("k_fin", "kernel", 176, 180, 6), DeviceOp("Memcpy DtoH", "memcpy", 192, 198, 7)]
CALLS = [Launch(1, 13, T), Launch(2, 46, T), Launch(3, 82, T), Launch(4, 101, T),
         Launch(5, 131, T), Launch(6, 171, T), Launch(7, 191, T)]


def _pass(bursts=1):
    return PS.analyse(RECORDS, OPS, CALLS, 0, 200, bursts, T)


def test_idle_pieces_cut_the_gaps_at_span_edges():
    assert PS.idle_pieces([(10, 20), (15, 30), (50, 60)], 0, 100, [5, 40, 45, 55, 100]) == [
        (0, 5), (5, 10), (30, 40), (40, 45), (45, 50), (60, 100)]
    assert PS.idle_pieces([], 0, 10, []) == [(0, 10)]
    assert PS.idle_pieces([(0, 10)], 0, 10, [5]) == []


def test_host_idle_and_device_time_per_span():
    p = _pass()
    assert p.host_ns["align"] == 35 and p.host_ns["merge"] == 30
    assert p.host_ns["process.upload"] == 18 and p.wait_ns == 18 + 8
    # idle: [0, 14] (harness 10, process 2, upload 2), [28, 50] (upload 2,
    # process 2, snr 8, pipeline 5, align 5), [70, 85] (align 10, robustness
    # 5), [118, 135] (kernels 2, pipeline 10, merge 5), [175, 176] (finishing
    # 1), [180, 192] (finishing 5, process 5, harness 2), [198, 200] (harness 2)
    assert p.idle_ns == {None: 14, "process": 9, "process.upload": 4, "process.snr": 8,
                         "process.pipeline": 15, "align": 15, "robustness": 5,
                         "kernels": 2, "merge": 5, "process.finishing": 6}
    assert p.device_ns == {"process.upload": 14, "align": 20, "robustness": 25,
                           "kernels": 8, "merge": 40, "process.finishing": 4, None: 6}
    assert p.launches["merge"] == 1 and p.launches["process.upload"] == 0
    assert p.entries["align"] == 1


def test_host_times_from_the_unprofiled_bursts():
    # the same spans twice as long, as an unprofiled burst's: the host times
    # are theirs, the idle and device times the profile's
    slow = [dict(r, start_ns=2 * r["start_ns"], end_ns=2 * r["end_ns"]) for r in RECORDS]
    p = PS.analyse(RECORDS, OPS, CALLS, 0, 200, 1, T, host=slow)
    assert p.host_ns["align"] == 70 and p.wait_ns == 2 * 26
    assert p.idle_ns == _pass().idle_ns and p.device_ns == _pass().device_ns


def test_idle_parts_add_up_to_the_whole():
    p = _pass()
    whole = 200 - union_ns([(o.start_ns, o.end_ns) for o in OPS], 0, 200)
    assert sum(p.idle_ns.values()) == whole == 83


def _view(bursts=1):
    att = attribute(OPS, [], [], CALLS)
    view = View(OPS, bursts, 0, 200, att, [], bursts)
    view.program = _pass(bursts)
    return view


@pytest.mark.parametrize("name,want", [
    ("host_ms.align", 35), ("host_ms.robustness", 20), ("host_ms.kernels", 20),
    ("host_ms.merge", 30), ("idle_ms.align", 15), ("idle_ms.robustness", 5),
    ("idle_ms.kernels", 2), ("idle_ms.merge", 5), ("idle_ms.process", 9 + 4 + 8 + 15 + 6),
    ("upload_ms", 18), ("host_wait_ms", 26)])
def test_readers_per_burst(name, want):
    # two bursts' worth of the same nanoseconds: half of it per burst, in ms
    assert load_reader(name).read(_view(bursts=2)) == pytest.approx(want / 2 / 1e6)


def test_readers_add_up_to_the_whole_idle():
    view = _view()
    parts = [load_reader(n).read(view) for n in
             ("idle_ms.align", "idle_ms.robustness", "idle_ms.kernels", "idle_ms.merge",
              "idle_ms.process")]
    outside = view.program.idle_ns[None] / 1e6
    assert sum(parts) + outside == pytest.approx(83 / 1e6, abs=1e-12)


def test_nothing_to_read_off_the_card_or_without_the_recorder(monkeypatch):
    view = View([], 1, 0, 200, attribute([], [], []), [], 1)
    view.cell = {"config": {}, "traffic": {}}
    assert load_reader("host_ms.align").read(view) is None       # no kernel: off the card
    from hmsr_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "collect")                       # a program without it
    card = View(OPS, 1, 0, 200, attribute(OPS, [], [], CALLS), [], 1)
    card.cell, card.shape = {"config": {}, "traffic": {}}, {}
    for name in ("host_ms.merge", "idle_ms.process", "upload_ms", "host_wait_ms"):
        assert load_reader(name).read(card) is None


def test_the_pass_on_the_cpu():
    from benchmark.run import load_json
    conf = load_json("benchmark", "configs", "burst20_12mp_x2.json")
    traffic = load_json("benchmark", "traffic", "host.json")
    view = View([], 1, 0, 1, attribute([], [], []), [], 1)
    view.cell = dict(config=conf, traffic=traffic)
    view.shape = dict(frames=3, height=256, width=256)
    p = PS.program_pass(view, device="cpu")
    from benchmark.run import TRACED_BURSTS
    assert p.bursts == TRACED_BURSTS
    per = {n: k // TRACED_BURSTS for n, k in p.entries.items()}
    assert per["align"] == per["robustness"] == per["kernels"] == 3      # 2 frames + reference
    assert per["merge"] == 1 and per["process"] == 1 and per["process.snr"] == 1
    # no device operation on the CPU: the whole window is idle, split among the spans
    assert sum(p.idle_ns.values()) == p.hi - p.lo
    assert p.host_ns["process"] > p.host_ns["process.pipeline"] > 0 and p.wait_ns > 0
    assert load_reader("upload_ms").read(view) > 0
