"""The device time split by the program's spans (`harness.spans`), on
synthetic traces as `harness.trace.collect` keeps them: host and device
intervals (name, start, end) in microseconds."""
from pytest import approx
from repro_torch.spans import NAMES

from bench.harness import spans as sp
from bench.harness import spec
from bench.harness import trace as tr


def trace(host, dev, lo=0, hi=1000):
    return {"host": [(n, float(a), float(b)) for n, a, b in host],
            "device": [(n, float(a), float(b)) for n, a, b in dev],
            "window": (tr.WINDOW_SPAN, float(lo), float(hi))}


def test_an_op_launched_on_another_thread_goes_to_the_open_span():
    # the backward's worker thread launches aten::mm while the main
    # thread waits inside step.backward: the mm is no child of the span
    # in any one thread's tree, but its launch lies inside it
    host = [("engine.tick", 0, 100), ("step.backward", 10, 60),
            ("autograd::engine::evaluate_function: MmBackward0", 15, 40),
            ("aten::mm", 20, 30), ("cudaLaunchKernel", 22, 23)]
    got = sp.split(trace(host, [("sgemm", 30, 45)]), NAMES)
    assert got["by_name"]["step.backward"]["device_s"] == approx(15e-6)
    assert got["by_name"]["engine.tick"]["device_s"] == 0
    assert got["unattributed_s"] == 0 and got["unpaired"] == 0


def test_nested_spans_charge_the_innermost():
    host = [("engine.tick", 0, 100), ("step.optimizer", 10, 50),
            ("aten::add", 20, 22), ("cudaLaunchKernel", 21, 22),
            # K1, bound through ctypes, launched by the span itself
            ("cuLaunchKernel", 30, 31),
            ("aten::where", 60, 62), ("cudaLaunchKernel", 61, 62)]
    dev = [("add_kernel", 25, 29), ("elastic_update_kernel", 40, 48),
           ("where_kernel", 62, 63)]
    got = sp.split(trace(host, dev), NAMES)["by_name"]
    assert got["step.optimizer"]["device_s"] == approx(12e-6)
    assert got["engine.tick"]["device_s"] == approx(1e-6)
    assert got["engine.tick"]["count"] == got["step.optimizer"]["count"] == 1
    assert got["engine.tick"]["host_s"] == approx(100e-6)


def test_copies_kernels_and_fills_pair_with_their_own_calls():
    # one stream: the k-th copy is the k-th copy call's, whatever kernels
    # were launched between them
    host = [("train.prepare", 0, 50), ("cudaMemcpyAsync", 1, 2),
            ("cudaMemsetAsync", 3, 4), ("engine.tick", 60, 100),
            ("cudaLaunchKernel", 61, 62), ("engine.readback", 110, 130),
            ("cudaMemcpyAsync", 111, 112)]
    dev = [("Memcpy HtoD (Pageable -> Device)", 5, 7),
           ("Memset (Device)", 7, 8), ("gemm", 62, 90),
           ("Memcpy DtoH (Device -> Pageable)", 112, 115)]
    got = sp.split(trace(host, dev), NAMES)["by_name"]
    assert got["train.prepare"]["device_s"] == approx(3e-6)
    assert got["engine.tick"]["device_s"] == approx(28e-6)
    assert got["engine.readback"]["device_s"] == approx(3e-6)


def test_an_op_without_its_launch_call_is_unattributed():
    # the copy call is missing: no later call is taken for the copy
    host = [("engine.tick", 0, 100), ("step.forward", 10, 50),
            ("cudaMemcpyAsync", 60, 61), ("cudaLaunchKernel", 20, 21)]
    dev = [("Memcpy HtoD (Pageable -> Device)", 22, 24),
           ("Memcpy DtoD (Device -> Device)", 62, 64),
           ("mystery_kernel", 30, 35)]
    got = sp.split(trace(host, dev), NAMES)
    assert got["by_name"]["step.forward"]["device_s"] == approx(5e-6)
    assert got["by_name"]["engine.tick"]["device_s"] == approx(2e-6)
    assert got["unattributed_s"] == approx(2e-6) and got["unpaired"] == 1


def test_only_the_window_is_charged():
    host = [("engine.tick", 0, 100), ("cudaLaunchKernel", 1, 2),
            ("cudaLaunchKernel", 3, 4)]
    dev = [("a", 5, 15), ("b", 15, 40)]
    got = sp.split(trace(host, dev, lo=10, hi=30), NAMES)["by_name"]
    assert got["engine.tick"]["device_s"] == approx(20e-6)
    assert got["engine.tick"]["count"] == 0


def test_call_idle_over_three_calls():
    host, dev = [], []

    def launch(at, dev_start, dev_end, name="k"):
        call = "cudaMemcpyAsync" if name.startswith("Memcpy") \
            else "cudaLaunchKernel"
        host.append((call, at, at + 0.5))
        dev.append((name, dev_start, dev_end))

    for a, b in ((0, 10), (10, 20), (30, 40), (50, 60)):
        host.append(("engine.tick", a, b))
    for a, b in ((21, 25), (41, 45)):
        host.append(("engine.readback", a, b))
    launch(1, 2, 12)        # call 1
    launch(11, 12, 23)
    launch(22, 24, 26, "Memcpy DtoH (Device -> Pageable)")  # readback
    launch(31, 33, 38)      # call 2
    launch(32, 38, 43)
    launch(51, 55, 58)      # call 3
    got = sp.split(trace(host, dev, hi=100), NAMES)
    # 23 … 33 less the readback's copy, then 43 … 55
    assert got["call_idle_s"] == approx([8e-6, 12e-6])
    assert got["by_name"]["engine.tick"]["count"] == 4
    assert got["by_name"]["engine.readback"]["device_s"] == approx(2e-6)
    facts = {"trace": trace(host, dev, hi=100), "ticks": 4}
    assert spec.metric_reader("call_idle_ms").read(facts) == approx(0.01)


def test_span_readers_read_device_ms_a_tick_and_nothing_without_spans():
    host = [("engine.tick", 0, 10), ("engine.market", 1, 5),
            ("cudaLaunchKernel", 2, 3), ("engine.tick", 10, 20),
            ("engine.market", 11, 15), ("cudaLaunchKernel", 12, 13)]
    dev = [("k", 3, 5), ("k", 13, 15)]
    facts = {"trace": trace(host, dev, hi=20), "ticks": 2}
    assert spec.metric_reader("market_tick_ms").read(facts) == approx(2e-3)
    for name in ("gate_ms", "forward_ms", "backward_ms", "optimizer_ms",
                 "call_idle_ms"):
        assert spec.metric_reader(name).read(facts) is None
    # a program without spans, or a run without a trace, reads nothing
    bare = {"trace": trace(host[2::3], dev, hi=20), "ticks": 2}
    for name in ("market_tick_ms", "gate_ms", "forward_ms", "backward_ms",
                 "optimizer_ms", "call_idle_ms"):
        assert spec.metric_reader(name).read(bare) is None, name
        assert spec.metric_reader(name).read({"ticks": 2}) is None, name


def test_a_program_without_span_names_reads_nothing(monkeypatch):
    monkeypatch.setattr(sp, "program_spans", lambda: ())
    host = [("engine.tick", 0, 10), ("cudaLaunchKernel", 2, 3)]
    facts = {"trace": trace(host, [("k", 3, 5)], hi=20), "ticks": 1}
    assert spec.metric_reader("forward_ms").read(facts) is None
    assert sp.split(facts["trace"], ()) is None


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


def _window_facts(rows):
    """The facts of a traced window whose profiler gave ``rows``."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from bench import run as bench_run

    parsed = [SimpleNamespace(
        name=name, time_range=_Range(a, b),
        device_type=DeviceType.CUDA if on_dev else DeviceType.CPU)
        for name, on_dev, a, b in rows]
    w = bench_run.Window(trace=True, on_card=True)
    w.prof = SimpleNamespace(events=lambda: parsed)
    return w.facts()


def test_host_spans_change_no_existing_fact_or_reader():
    from bench import peaks

    base = [(tr.WINDOW_SPAN, False, 0, 1000),
            ("aten::mm", False, 100, 110),
            ("cudaLaunchKernel", False, 101, 102),
            ("sgemm", True, 105, 300),
            ("aten::copy_", False, 320, 330),
            ("cudaMemcpyAsync", False, 321, 322),
            ("Memcpy DtoD (Device -> Device)", True, 325, 340),
            ("cuLaunchKernel", False, 395, 396),
            ("elastic_update_kernel", True, 400, 420),
            ("aten::where", False, 600, 610),
            ("cudaLaunchKernel", False, 601, 602),
            ("where_kernel", True, 605, 640)]
    spans = [("engine.tick", False, 90, 500),
             ("step.forward", False, 95, 200),
             ("step.optimizer", False, 390, 450),
             ("engine.tick", False, 560, 700),
             ("engine.gate", False, 590, 650)]
    plain, traced = _window_facts(base), _window_facts(base + spans)
    for key in ("trace_window_s", "busy_s", "kernels"):
        assert plain[key] == traced[key], key
    assert plain["breakdown"]["device_ops"] == \
        traced["breakdown"]["device_ops"]
    assert plain["trace"]["device"] == traced["trace"]["device"]
    cell = spec.cell("qwen2-7b.megabatch-f32")
    common = {"ticks": 2, "cell_steps": 4, "running_steps": 1,
              "leaves": cell.reference.leaves(cell.config),
              "conf": cell.config, "traffic": cell.traffic,
              "reference": cell.reference,
              "peaks": peaks.card_peaks("NVIDIA H100 80GB HBM3")}
    for m in ("launches_per_tick", "device_idle_pct", "mfu", "k1_roofline",
              "k2_roofline"):
        reader = spec.metric_reader(m)
        assert reader.read({**common, **plain}) == \
            reader.read({**common, **traced}), m
    # the program's spans name the idle gaps they hold
    assert "engine.tick" in {n for n, _ in traced["breakdown"]["idle_gaps"]}
    assert sp.split(plain["trace"], NAMES) is None
    by = sp.split(traced["trace"], NAMES)["by_name"]
    assert by["engine.tick"]["count"] == 2
    assert by["step.forward"]["device_s"] == approx(195e-6)
    assert by["step.optimizer"]["device_s"] == approx(20e-6)
    assert by["engine.tick"]["device_s"] == approx(15e-6)
    assert by["engine.gate"]["device_s"] == approx(35e-6)


def test_launch_classes():
    assert sp.launch_class("cudaLaunchKernel") == "kernel"
    assert sp.launch_class("cudaLaunchKernelExC") == "kernel"
    assert sp.launch_class("cuLaunchKernelEx") == "kernel"
    assert sp.launch_class("cudaMemcpyAsync") == "copy"
    assert sp.launch_class("cudaMemsetAsync") == "fill"
    for name in ("cudaStreamSynchronize", "cudaEventRecord", "aten::mm",
                 "step.forward", "cudaGetDevice"):
        assert sp.launch_class(name) is None
    assert sp.device_class("Memcpy DtoH (Device -> Pinned)") == "copy"
    assert sp.device_class("Memset (Device)") == "fill"
    assert sp.device_class("ampere_sgemm_128x64_nn") == "kernel"
