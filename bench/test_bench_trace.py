"""The trace's arithmetic: busy union, top operations, idle gaps."""
from bench.harness import trace as tr


def test_busy_union_clips_to_the_window_and_merges_overlaps():
    dev = [("k1", 0, 10), ("k2", 5, 20), ("k3", 30, 40), ("k4", 95, 120)]
    assert tr.busy_us(dev, 0, 100) == 20 + 10 + 5


def test_top_ops_and_gaps_named_by_the_innermost_host_op():
    dev = [("gemm", 0, 10), ("gemm", 20, 30), ("copy", 60, 61)]
    host = [("bench.chunk", 0, 100), ("aten::item", 35, 58)]
    assert tr.top_ops(dev, 0, 100) == [["gemm", 20e-6], ["copy", 1e-6]]
    gaps = tr.idle_gaps(dev, host, 0, 100)
    assert gaps[0] == ["bench.chunk", 39e-6]          # 61 … 100
    assert gaps[1] == ["aten::item", 30e-6]           # 30 … 60
    assert gaps[2] == ["bench.chunk", 10e-6]          # 10 … 20


def test_kernel_stats_leave_out_copies():
    dev = [("gemm", 0, 10), ("Memcpy HtoD (Pageable -> Device)", 12, 14),
           ("gemm", 20, 25), ("Memset (Device)", 30, 31)]
    stats = tr.kernel_stats(dev, 0, 100)
    assert list(stats) == ["gemm"] and stats["gemm"][0] == 2
    assert abs(stats["gemm"][1] - 15e-6) < 1e-12
