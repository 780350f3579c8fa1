"""The trace reduction on a small synthetic trace: attribution of device
operations to spans by their host operation, busy time, idle gaps, the
breakdown and the readers' view."""

import pytest

from benchmark.trace import (OUTSIDE, DeviceOp, Launch, Span, View, attribute, enclosing,
                             idle_gaps, percentile_sorted, top_ops, union_ns)

T = 7           # the host thread

# burst [0, 100]: process_arrays [5, 95] > pipeline [10, 80] > align [20, 40], merge [50, 70]
SPANS = [Span("burst", 0, 100, T), Span("process_arrays", 5, 95, T), Span("pipeline", 10, 80, T),
         Span("align", 20, 40, T), Span("merge", 50, 70, T)]
# operators (id, start): one in align, one in the entry, one in the burst's download,
# one on another thread; runtime calls (CUPTI id, start): the ctypes launch of a
# kernel inside the merge span, outside any operator
OPERATORS = [Launch(1, 25, T), Launch(3, 7, T), Launch(4, 96, T), Launch(5, 30, T + 1)]
CALLS = [Launch(502, 60, T), Launch(501, 26, T)]
OPS = [DeviceOp("k_align", "kernel", 30, 45, 501, 1),
       DeviceOp("merge_kernel", "kernel", 55, 75, 502),
       DeviceOp("Memcpy HtoD (Pageable -> Device)", "memcpy", 8, 20, 503, 3),
       DeviceOp("Memcpy DtoH (Device -> Pageable)", "memcpy", 96, 99, 504, 4),
       DeviceOp("k_other", "kernel", 46, 48, 505, 5), DeviceOp("k_lost", "kernel", 80, 82, 599)]


def test_enclosing_picks_the_innermost_open_span():
    pts = [(25, T), (50, T), (45, T), (80, T), (100, T), (101, T), (25, T + 1)]
    assert enclosing(pts, SPANS) == ["align", "merge", "pipeline", "process_arrays", None,
                                     None, None]


def test_attribution_by_operator_or_runtime_call():
    att = attribute(OPS, OPERATORS, SPANS, CALLS)
    assert att.span_of == ["align", "merge", "process_arrays", "burst", None, None]
    assert att.unmatched == 1


def test_union_and_idle_gaps():
    iv = [(o.start_ns, o.end_ns) for o in OPS]
    # [8, 20], [30, 45], [46, 48], [55, 75], [80, 82], [96, 99]
    assert union_ns(iv) == 12 + 15 + 2 + 20 + 2 + 3
    assert union_ns(iv, 10, 60) == 10 + 15 + 2 + 5
    gaps = idle_gaps(OPS, SPANS, 0, 100)
    assert gaps[0] == ["process_arrays", 14e-9]     # [82, 96], its middle at 89
    assert gaps[1] == ["align", 10e-9]              # [20, 30], its middle at 25
    assert sorted(g[1] for g in gaps) == pytest.approx(sorted(
        x * 1e-9 for x in (8, 10, 1, 7, 5, 14, 1)))
    assert idle_gaps(OPS, [], 0, 100)[0][0] == OUTSIDE


def test_top_ops_sums_by_name():
    ops = OPS + [DeviceOp("k_align", "kernel", 200, 210, 1)]
    top = top_ops(ops, top=2)
    assert top == [["k_align", 25e-9], ["merge_kernel", 20e-9]]


def test_view_device_and_host_ms():
    att = attribute(OPS, OPERATORS, SPANS, CALLS)
    view = View(OPS, 1, 0, 100, att, SPANS, 1)
    assert view.device_ms(("align",)) == pytest.approx(15e-6)
    assert view.device_ms(("align", "merge")) == pytest.approx(35e-6)
    assert view.device_ms(("compute_robustness",)) is None      # never entered
    view.host, view.window_bursts = {"pipeline": 0.5}, 4
    assert view.host_ms("pipeline") == 125.0
    assert view.host_ms("align") is None
    assert len(view.ops_of_kind("memcpy")) == 2
    empty = View([], 1, 0, 100, attribute([], [], SPANS), SPANS, 1)
    assert empty.device_ms(("align",)) is None


def test_burst_min_reads_the_window_latencies():
    from benchmark.run import load_reader
    view = View([], 1, 0, 100, attribute([], [], SPANS), SPANS, 1)
    view.latencies = [0.3, 0.1, 0.2, 0.5, 0.4, 0.6, 0.9, 0.8, 0.7, 1.0, 1.1]
    assert load_reader("burst_min_s").read(view) == 0.1
    view.latencies = []
    assert load_reader("burst_min_s").read(view) is None


def test_percentile_matches_numpy_rule():
    assert percentile_sorted([4, 1, 3, 2], 0.75) == 3.25
    assert percentile_sorted([5], 0.75) == 5
    assert percentile_sorted([], 0.5) is None

