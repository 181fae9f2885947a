"""The per-layer metrics that read the program's spans: each reader on a
made-up trace and records (operations placed by their launch, the
division by calls or steps, forward and backward segments summed),
nothing read without device seconds, from a program without spans or
from unmatched launches, and on the card the layers' device time against
the busy time of a short traced run of each cell."""

from types import SimpleNamespace as NS

import pytest
import torch

from gan_rl_3d_tpu_torch.utils import profiling
from perfbench import harness, spans

SERVE = ("serve.encoder", "serve.tail", "serve.gate")
TRAIN = ("encoder_ms.per_step", "decoder_ms.per_step", "chamfer_ms.per_step",
         "preprocess_ms.per_step", "optimizer_ms.per_step")


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


MS = 1e-3


def _rec(name, request, t_start=None, host_s=None, phase=None):
    r = {"name": name, "parent": None, "request": request,
         "t_start": t_start, "host_s": host_s, "device_s": 0.1}
    if phase:
        r["phase"] = phase
    return r


def _calls():
    """Two served calls, at 0 and 100 ms: (host events, device operations,
    records). Each launches K1 in the encoder, two GEMMs in the tail and
    one in the gate, and the caller copies a result outside any span."""
    host, device, recs = [], [], []
    for i in range(2):
        b = 100 * i
        host += [(b, b + 50, "serve.call"), (b + 1, b + 10, "serve.encoder"),
                 (b + 2, b + 3, "cudaLaunchKernel"),
                 (b + 11, b + 30, "serve.tail"),
                 (b + 12, b + 13, "cudaLaunchKernel"),
                 (b + 14, b + 15, "cudaLaunchKernelExC"),
                 (b + 31, b + 40, "serve.gate"),
                 (b + 32, b + 33, "cuLaunchKernel"),
                 (b + 60, b + 61, "cudaMemcpyAsync"),
                 (b + 61, b + 62, "cudaDeviceSynchronize")]
        device += [(b + 5, b + 45, "K1"), (b + 45, b + 46 + i, "gemm"),
                   (b + 47, b + 49, "gemm"), (b + 49, b + 49.5, "gate"),
                   (b + 62, b + 62.5, "Memcpy DtoH")]
        recs += [_rec(n, i) for n in ("serve.call", "serve.encoder",
                                      "serve.tail", "serve.gate")]
    return host, device, recs


def _steps():
    """Two training steps, at 0 and 100 ms, each layer launching forward
    and, inside ``ae.backward``, backward; the records' clock runs 1 s
    ahead of the trace's."""
    host, device, recs = [], [], []
    for i in range(2):
        b = 100 * i
        for name, (h0, h1), launch, ms in (
                ("ae.batch", (1, 5), 2, 1), ("ae.preprocess", (6, 10), 7, 2),
                ("ae.encoder", (11, 20), 12, 10),
                ("ae.decoder", (21, 30), 22, 4),
                ("ae.chamfer", (31, 40), 32, 3),
                ("ae.backward", (41, 80), 45, 5),       # chamfer's backward
                ("ae.backward", (41, 80), 55, 6),       # the decoder's
                ("ae.backward", (41, 80), 65, 20 + i),  # the encoder's
                ("ae.backward", (41, 80), 75, 0.5),     # after the hooks
                ("ae.optimizer", (81, 90), 82, 0.7)):
            if name != "ae.backward" or launch == 45:
                host.append((b + h0, b + h1, name))
            host.append((b + launch, b + launch + 0.5, "cudaLaunchKernel"))
            end = device[-1][1] if device else 0
            start = max(end, b + launch + 1)
            device.append((start, start + ms, "kernel"))
        host.append((b, b + 95, "ae.step"))
        pc = 1000 + b
        recs += [_rec("ae.step", i), _rec("ae.backward", i, pc + 41, 39),
                 _rec("ae.chamfer", i, pc + 42, 8, "backward"),
                 _rec("ae.decoder", i, pc + 50, 10, "backward"),
                 _rec("ae.encoder", i, pc + 60, 10, "backward")]
    return host, device, recs


def _seconds(events):
    return sorted((a * MS, b * MS, n) for a, b, n in events)


def _ctx(monkeypatch, made):
    """The readers' context over a made-up trace, with the records in
    place of the program's."""
    host, device, recs = made
    recs = [dict(r, t_start=r["t_start"] and r["t_start"] * MS,
                 host_s=r["host_s"] and r["host_s"] * MS) for r in recs]
    monkeypatch.setattr(profiling, "span_records", lambda: recs)
    return {"trace": NS(host=_seconds(host), device=_seconds(device))}


def _read(name, ctx):
    return harness.reader(name).read(ctx)


def test_the_tail_reads_per_call(monkeypatch):
    ctx = _ctx(monkeypatch, _calls())
    assert _read("tail_ms.per_call", ctx) == pytest.approx(
        (1 + 2 + 2 + 2 + 2 * 0.5) / 2)


def test_the_step_layers_sum_forward_and_backward_per_step(monkeypatch):
    ctx = _ctx(monkeypatch, _steps())
    expect = {"encoder_ms.per_step": 10 + 20.5, "decoder_ms.per_step": 4 + 6,
              "chamfer_ms.per_step": 3 + 5, "preprocess_ms.per_step": 1 + 2,
              "optimizer_ms.per_step": 0.7}
    for name, value in expect.items():
        assert _read(name, ctx) == pytest.approx(value), name
    seconds, counts = spans.layer_seconds(ctx)
    assert seconds["ae.backward"] == pytest.approx(2 * 0.5 * MS)
    assert counts["ae.step"] == 2 and counts["ae.encoder"] == 4


def test_a_launch_without_its_device_operation_reads_nothing(monkeypatch):
    host, device, recs = _steps()
    ctx = _ctx(monkeypatch, (host, device[:-1], recs))
    assert _read("encoder_ms.per_step", ctx) is None


def test_set_up_reads_the_optimizers_host_seconds(monkeypatch):
    ctx = _ctx(monkeypatch, _steps())
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "setup.optimizer": {"count": 1, "host_s": 7.5},
        "ae.step": {"count": 2, "host_s": 0.2}})
    assert _read("setup.optimizer_s", ctx) == 7.5


@pytest.mark.parametrize("name", ("tail_ms.per_call", "setup.optimizer_s")
                         + TRAIN)
def test_readers_find_nothing_without_device_seconds(monkeypatch, name):
    made = _calls() if name.startswith("tail") else _steps()
    ctx = _ctx(monkeypatch, made)
    on_cpu = [dict(r, device_s=None) for r in profiling.span_records()]
    monkeypatch.setattr(profiling, "span_records", lambda: on_cpu)
    assert _read(name, ctx) is None
    # a program without spans
    monkeypatch.delattr(profiling, "span_records")
    monkeypatch.delattr(profiling, "span_totals")
    assert _read(name, ctx) is None


def _coverage(card, name, seed, size):
    """(the layers' device seconds, the spans' stream seconds by their
    events, the busy seconds), each per call or step, of a short traced
    run of the cell at its own widths and batch."""
    cell = harness.Cell(name, seed)
    cell.traffic.update(size)
    run = cell.mode().Run(cell, card)
    try:
        got = run.trace()
        ctx = dict(got, cell=cell)
        n = got["steps"]
        parent = "serve.call" if name == "pointnet-serve-bulk" else "ae.step"
        stream = sum(r["device_s"] for r in profiling.span_records()
                     if r["name"] == parent) / n
        if parent == "serve.call":
            seconds, counts = spans.layer_seconds(ctx)
            assert counts[parent] == n
            layers = sum(seconds[s] for s in SERVE) / n
        else:
            layers = sum(harness.reader(m).read(ctx) for m in TRAIN) * 1e-3
        return layers, stream, got["trace"].busy_s() / n
    finally:
        run.answers()
        del run
        torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("name,size", [
    ("pointnet-serve-bulk", {"trace_calls": 8}),
    ("attn-adaptive-train-ae", {"trace_steps": 4})])
def test_the_spans_cover_the_busy_time(card, name, size):
    layers, stream, busy = _coverage(card, name, 2**31 + 61, size)
    print(f"{name}: layers {layers * 1e3:.3f} ms, stream {stream * 1e3:.3f} "
          f"ms, busy {busy * 1e3:.3f} ms a call or step: layers "
          f"{100 * layers / busy:.2f}% of busy")
    assert 0.97 <= layers / busy <= 1.02
