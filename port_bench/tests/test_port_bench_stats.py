"""The benchmark's arithmetic on made-up numbers and intervals."""

import pytest

from port_bench import stats
from port_bench.trace import TraceView


def test_union_length_merges_overlaps_and_skips_gaps():
    assert stats.union_length([(0, 4), (2, 6), (8, 9), (8.5, 8.7)]) == 7
    assert stats.union_length([]) == 0


def test_idle_gaps_are_the_uncovered_stretches():
    assert stats.idle_gaps([(2, 4), (3, 5), (7, 8)], 0, 10) == [
        (0, 2), (5, 7), (8, 10)]
    assert stats.idle_gaps([(-1, 11)], 0, 10) == []


def test_p95():
    assert stats.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert stats.p95([3.0] * 7) == 3.0


def test_bound_takes_the_larger_of_operations_and_bytes():
    name = "NVIDIA H100 80GB HBM3"
    assert stats.bound_ms(67e9, 0, name) == pytest.approx(1.0)
    assert stats.bound_ms(0, 3.35e9, name) == pytest.approx(1.0)
    assert stats.bound_ms(67e9, 6.7e9, name) == pytest.approx(2.0)
    with pytest.raises(KeyError):
        stats.peaks("some other card")


def _events():
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                    "ts": ts, "dur": dur}
    return [
        x("user_annotation", "bench.window", 0, 100),
        x("user_annotation", "bench.step", 1, 4),
        x("user_annotation", "bench.step", 50, 6),
        x("cpu_op", "aten::add", 52, 2),
        x("kernel", "void megakernel_walk<true, true, 0, 0>()", 5, 40),
        x("kernel", "elementwise", 30, 20),
        x("kernel", "void megakernel_walk<true, true, 0, 0>()", 60, 30),
        x("kernel", "after the window", 200, 5),
    ]


def test_trace_view_reads_the_window():
    v = TraceView(_events(), units=2)
    assert v.window_s == pytest.approx(1e-4)
    assert v.busy_s == pytest.approx(75e-6)
    k2 = lambda n: "megakernel_walk" in n
    assert v.device_ms(k2) == pytest.approx(0.035)
    assert v.count(k2) == 2
    assert v.host_ms("bench.step") == pytest.approx(0.005)
    assert v.host_ms("bench.missing") is None
    b = v.breakdown()
    assert b["device_ops"][0] == ["void megakernel_walk<true, true, 0, 0>()",
                                  pytest.approx(70e-6)]
    # Gaps [0, 5), [50, 60), [90, 100), each named by the innermost host
    # span at its middle.
    assert [g[0] for g in b["idle_gaps"]] == ["bench.step", "bench.window",
                                              "bench.step"]
    assert [g[1] for g in b["idle_gaps"]] == [pytest.approx(1e-5),
                                              pytest.approx(1e-5),
                                              pytest.approx(5e-6)]


def test_trace_view_refuses_a_window_without_device_ops():
    with pytest.raises(RuntimeError):
        TraceView(_events()[:4], units=1)
