"""Faults planted underneath the timed path, for showing that the
correctness check fails them: each is a context manager that patches the
program while a run is set up and measured.

* ``state_unchanged``: the optimizer's step does nothing, so a training
  step returns its state unchanged.
* ``half_batch``: half of each batch is left out; a training step takes
  the mean over the rest, a served call completes the first half and
  repeats it for the second.
* ``answer_altered``: one served cloud's completion (and hybrid output)
  is moved where it is produced.
* ``schedule_by_step``: the learning-rate schedule counts each step as an
  epoch.

Each cell's file ``workloads/<cell>.json`` names the faults it can have.
"""

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def state_unchanged():
    def step(self, *args, **kwargs):
        return None

    with mock.patch.object(torch.optim.Adam, "step", step):
        yield


@contextlib.contextmanager
def half_batch():
    from gan_rl_3d_tpu_torch.models import inference
    from gan_rl_3d_tpu_torch.train import steps

    step, serve = steps.ae_train_step, inference.complete_fast

    def half_step(params, bn_state, optimizer, batch, draws, **kw):
        keep = batch["complete_pc"].shape[0] // 2
        return step(params, bn_state, optimizer,
                    {k: v[:keep] for k, v in batch.items()},
                    {k: v[:keep] for k, v in draws.items()}, **kw)

    def half_serve(engine, pc, mask=None, **kw):
        keep = pc.shape[0] // 2
        out = serve(engine, pc[:keep], mask[:keep], **kw)
        return {k: torch.cat([v, v])[:pc.shape[0]] for k, v in out.items()}

    with mock.patch.object(steps, "ae_train_step", half_step), \
            mock.patch.object(inference, "complete_fast", half_serve):
        yield


@contextlib.contextmanager
def answer_altered():
    from gan_rl_3d_tpu_torch.models import inference

    serve = inference.complete_fast

    def altered(engine, pc, mask=None, **kw):
        out = serve(engine, pc, mask, **kw)
        for k in ("completed_pc", "hybrid_output"):
            out[k][0, 0] += 0.1
        return out

    with mock.patch.object(inference, "complete_fast", altered):
        yield


@contextlib.contextmanager
def schedule_by_step():
    from gan_rl_3d_tpu_torch.train import steps

    make = steps.make_ae_optimizer

    def by_step(params, cfg, steps_per_epoch):
        return make(params, cfg, 1)

    with mock.patch.object(steps, "make_ae_optimizer", by_step):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered,
          "schedule_by_step": schedule_by_step}
