"""The trace arithmetic on made-up events: busy time as the union of the
device events, annotations left out, idle gaps named by the innermost
host event, kernels found by name; and the per-layer readers on it. A
traced run on the CPU times its window without the profiler."""

from types import SimpleNamespace as NS

import pytest
import torch

from perfbench import harness, trace, work
from perfbench.trace import Trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(name, start_us, end_us, device):
    return NS(name=name, device_type=device,
              time_range=NS(start=start_us, end=end_us))


K1 = "void encoder_pool_kernel<128, false, true>(float const*)"
K3 = "void nn_kernel<true, false>(float const*, float const*)"


def _trace():
    events = [
        _event("step", 0, 1000, CPU),
        _event("aten::mm", 10, 40, CPU),
        _event("cudaLaunchKernel", 20, 30, CPU),
        _event("aten::copy_", 500, 900, CPU),
        _event("step", 100, 900, CUDA),          # an annotation's device range
        _event(K1, 100, 300, CUDA),
        _event(K3, 250, 400, CUDA),              # overlaps K1
        _event("void nn_kernel<false, false>(float const*)", 600, 650, CUDA),
        _event("Memcpy HtoD", 700, 710, CUDA),
    ]
    return Trace(NS(events=lambda: events), window_s=1e-3, traced_s=2e-3)


def test_busy_time_is_the_union_of_device_events():
    tr = _trace()
    assert tr.launches() == 4
    assert tr.busy_s() == pytest.approx((300 + 50 + 10) * 1e-6)


def test_kernels_by_exact_name():
    tr = _trace()
    k1 = harness.reader("k1_f32_roofline").NAME
    k3 = harness.reader("k3_roofline").NAME
    assert tr.kernel_seconds(k1) == (1, pytest.approx(200e-6))
    assert tr.kernel_seconds(k3) == (1, pytest.approx(150e-6))


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(_trace().idle_gaps())
    # 0-100 has its middle in "step" alone; 400-600, 650-700 and 710-1000
    # have theirs in aten::copy_ (500-900), the innermost event there
    assert gaps == {"step": pytest.approx(100e-6),
                    "aten::copy_": pytest.approx((200 + 50 + 290) * 1e-6)}


def test_readers_on_a_trace():
    cell = harness.Cell("attn-adaptive-train-ae", 1)
    tr = _trace()
    ctx = {"trace": tr, "cell": cell, "steps": 2, "clouds": 2 * 1024,
           "points": 2048, "kept_points": [1_300_000, 1_400_000],
           "timed_kept_points": [1_350_000, 1_250_000]}
    assert harness.reader("launches.per_step").read(ctx) == 2
    assert harness.reader("device_idle.train").read(ctx) \
        == pytest.approx(100 * (1 - 360e-6 / 1e-3))
    bound = work.bound_seconds(*work.k3(1024, 2048, 2048))
    assert harness.reader("k3_roofline").read(ctx) \
        == pytest.approx(100 * bound / 150e-6)
    flops = sum(work.train_flops(cell.config["model"]["autoencoder"], k,
                                 1024) for k in ctx["timed_kept_points"])
    assert harness.reader("mfu.train").read(ctx) \
        == pytest.approx(100 * flops / 1e-3 / 67e12)


def test_readers_find_nothing_without_device_events():
    cell = harness.Cell("pointnet-serve-bulk", 1)
    empty = Trace(NS(events=lambda: [_event("step", 0, 10, CPU)]), 1e-5,
                  2e-5)
    ctx = {"trace": empty, "cell": cell, "steps": 1, "clouds": 4096,
           "points": 2048, "kept_points": [5_000_000],
           "timed_kept_points": [5_000_000]}
    for m in cell.metrics("per_layer"):
        assert harness.reader(m["name"]).read(ctx) is None, m["name"]


def test_traced_warms_up_times_untraced_then_traces():
    passes = []

    def work_once():
        passes.append(torch._C._autograd._profiler_enabled())
        torch.ones(64, 64) @ torch.ones(64, 64)

    tr = trace.traced(work_once, torch.device("cpu"))
    assert passes == [False, False, True]
    assert 0 < tr.window_s and 0 < tr.traced_s
    assert any(name == "aten::mm" for _, _, name in tr.host)


@pytest.mark.parametrize("name", [w["name"] for w in harness.read_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]])
def test_a_traced_run_on_the_cpu(name):
    cell = harness.Cell(name, 2**31 + 41)
    cell.traffic.update(cell.spec["small"])
    run = cell.mode().Run(cell, torch.device("cpu"))
    got = run.trace()
    steps = got["steps"]
    assert got["attempted"] == 3 * steps
    assert len(got["kept_points"]) == len(got["timed_kept_points"]) == steps
    assert got["trace"].window_s > 0 and got["trace"].traced_s > 0
    mode = cell.mode()
    numbers = mode.numbers(run.answers(), run.reference(tf32=False))
    assert harness.judge(numbers, cell.limits)[0], numbers
