"""The port's spans (gan_rl_3d_tpu_torch/utils/profiling.py) in the serving
call and the AE training step: totals only while no profiler records,
records nested by call and step under ``torch.profiler``, the backward
pass split at the layers' gradients, the same numbers with and without
the profiler, set-up in the totals, and ``spans.json`` beside a trace.
CPU, small widths; records carry no device seconds here."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gan_rl_3d_tpu_torch.config import AETrainConfig
from gan_rl_3d_tpu_torch.models import inference
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.train import steps
from gan_rl_3d_tpu_torch.utils import profiling
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_modules import N_POINTS, port_small_config

SERVE = {"serve.call", "serve.encoder", "serve.tail", "serve.gate"}
AE = {"ae.step", "ae.batch", "ae.preprocess", "ae.encoder", "ae.decoder",
      "ae.chamfer", "ae.backward", "ae.optimizer"}
B, SPLIT = 4, 8


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def model():
    return tnet.init_model(torch.Generator().manual_seed(5),
                           port_small_config())


@pytest.fixture(scope="module")
def engine(model):
    return inference.prepare_inference_engine(
        {"ae": model["ae"], "lgan": model["lgan"],
         "agent": {"actor": model["agent"]["actor"]}})


def _scans(seed):
    g = torch.Generator().manual_seed(seed)
    pc = torch.randn(B, N_POINTS, 3, generator=g)
    mask = (torch.rand(B, N_POINTS, generator=g) > 0.3).float()
    return pc, mask


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _ranges(events, name):
    return [e.time_range for e in events if e.name == name]


def _within(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end


class _Trainer:
    """Fresh AE parameters, optimizer and draws from one seed, and
    ``ae_train_epoch`` over the first ``steps`` rows of a fixed plan."""

    def __init__(self, model):
        ae = model["ae"]
        self.params = tree_map(lambda v: v.clone().requires_grad_(True),
                               ae["params"])
        self.state = tree_map(torch.clone, ae["state"])
        self.opt, self.sched = steps.make_ae_optimizer(
            self.params, AETrainConfig(lr=1e-3), SPLIT // B)
        g = torch.Generator().manual_seed(11)
        self.data = torch.randn(SPLIT, N_POINTS, 3, generator=g)
        self.order = torch.randperm(SPLIT, generator=g).view(-1, B)
        self.draws = torch.Generator().manual_seed(12)

    def run(self, n):
        self.state, m = steps.ae_train_epoch(
            self.params, self.state, self.opt, self.sched, self.data,
            self.order[:n], torch.zeros(n, B), self.draws,
            spec=pc_ops.PreprocSpec())
        return m["losses"]


def test_without_a_profiler_a_span_only_adds_to_its_totals():
    before = profiling.span_totals().get("serve.call",
                                         {"count": 0, "host_s": 0.0})
    with profiling.span("serve.call"):
        torch.ones(8).sum()
    after = profiling.span_totals()["serve.call"]
    assert after["count"] == before["count"] + 1
    assert after["host_s"] > before["host_s"]
    assert profiling.span_records() == []


def test_serving_spans_nest_under_one_call_each(engine):
    pc, mask = _scans(1)

    def two_calls():
        for _ in range(2):
            inference.complete_fast(engine, pc, mask, hybrid=True)

    _, events = _profiled(two_calls)
    records = profiling.span_records()
    assert {r["name"] for r in records} == SERVE
    calls = [r for r in records if r["name"] == "serve.call"]
    assert [r["parent"] for r in calls] == [None, None]
    assert len({r["request"] for r in calls}) == 2
    for call in calls:
        mine = [r for r in records if r["request"] == call["request"]]
        assert sorted(r["name"] for r in mine) == sorted(SERVE)
        assert all(r["parent"] == "serve.call" for r in mine
                   if r is not call)
        assert all(r["host_s"] > 0 and r["device_s"] is None for r in mine)
    # host events of the trace, each layer inside a call
    outer = _ranges(events, "serve.call")
    assert len(outer) == 2
    for name in SERVE - {"serve.call"}:
        inner = _ranges(events, name)
        assert len(inner) == 2
        assert all(any(_within(i, o) for o in outer) for i in inner)


def test_ae_step_spans_nest_under_one_step(model):
    trainer = _Trainer(model)
    _, events = _profiled(lambda: trainer.run(1))
    records = profiling.span_records()
    forward = [r for r in records if "phase" not in r]
    assert sorted(r["name"] for r in forward) == sorted(AE)
    assert len({r["request"] for r in records}) == 1
    parents = {r["name"]: r["parent"] for r in forward}
    assert parents["ae.step"] is None
    assert all(parents[n] == "ae.step" for n in AE - {"ae.step"})
    (step,) = _ranges(events, "ae.step")
    for name in AE - {"ae.step"}:
        (inner,) = _ranges(events, name)
        assert _within(inner, step)


def test_the_backward_pass_is_charged_chamfer_then_decoder_then_encoder(
        model):
    trainer = _Trainer(model)
    _profiled(lambda: trainer.run(2))
    records = profiling.span_records()
    for request in (0, 1):
        back = [r for r in records
                if r.get("phase") == "backward" and r["request"] == request]
        assert [r["name"] for r in back] == ["ae.chamfer", "ae.decoder",
                                             "ae.encoder"]
        assert all(r["parent"] == "ae.backward" and r["host_s"] >= 0
                   for r in back)


def test_spans_and_hooks_change_no_number(model, engine):
    pc, mask = _scans(2)
    plain = inference.complete_fast(engine, pc, mask)
    traced, _ = _profiled(lambda: inference.complete_fast(engine, pc, mask))
    assert set(plain) == set(traced)
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    a, b = _Trainer(model), _Trainer(model)
    loss_a = a.run(2)
    loss_b, _ = _profiled(lambda: b.run(2))
    assert profiling.span_records()
    assert torch.equal(loss_a, loss_b)
    for tree in ("params", "state"):
        for x, y in zip(tree_leaves(getattr(a, tree)),
                        tree_leaves(getattr(b, tree))):
            assert torch.equal(x, y), tree


def test_optimizer_set_up_is_in_the_totals(model):
    before = profiling.span_totals().get("setup.optimizer",
                                         {"count": 0})["count"]
    _Trainer(model)
    assert profiling.span_totals()["setup.optimizer"]["count"] == before + 1
    assert profiling.span_records() == []


def test_trace_writes_the_spans_beside_the_chrome_trace(engine, tmp_path):
    pc, mask = _scans(3)
    with profiling.trace(str(tmp_path / "prof")):
        inference.complete_fast(engine, pc, mask)
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert sorted(r["name"] for r in spans["records"]) == sorted(SERVE)
    assert spans["totals"]["serve.call"]["count"] >= 1
    assert profiling.span_records() == []
