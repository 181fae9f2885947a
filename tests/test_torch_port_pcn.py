"""PCN (``models/pcn.py``) through the port's normal path, held to the plain
reference ``tests/reference_pcn.py``: the forward pass, the loss, every
leaf's gradient, one Adam update, the alpha and learning-rate schedules,
the input draws, the configuration's fields, the spans, ``complete`` and
the phase-1 CLI. CPU tests at B=2, 64-row inputs, 32 coarse points, a 2x2
grid and 128-point targets, published widths otherwise. Imports no JAX,
so on a GPU machine the card tests run as

  python -m pytest --noconftest tests/test_torch_port_pcn.py -m cuda

(the published widths at B=4; K3/K4/K5 at PCN's sizes). The ``cuda``
tests skip where no GPU is visible."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reference_pcn as ref
from gan_rl_3d_tpu_torch import config as cfg_lib
from gan_rl_3d_tpu_torch import evaluate
from gan_rl_3d_tpu_torch.data import setup_dataset
from gan_rl_3d_tpu_torch.models import autoencoder as ae
from gan_rl_3d_tpu_torch.models import inference, pcn
from gan_rl_3d_tpu_torch.models import latent_gan as lg
from gan_rl_3d_tpu_torch.models import rl_agent as rl
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.ops import _cuda, chamfer
from gan_rl_3d_tpu_torch.ops import pointcloud as pc_ops
from gan_rl_3d_tpu_torch.train import steps
from gan_rl_3d_tpu_torch.train.trainer import RLGANNetTrainer
from gan_rl_3d_tpu_torch.utils import profiling
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
B, N_IN, COARSE, GRID, N_GT = 2, 64, 32, 2, 128
SCALE = 0.05
SPEC = pc_ops.PreprocSpec(rotation=False, jitter=False, scale=False,
                          normalize=False, center=False, unit_sphere=False)
RECIPE = cfg_lib.AETrainConfig(
    lr=1e-4, weight_decay=0.0, lr_schedule="staircase", scheduler_gamma=0.7,
    decay_steps=50000, lr_floor=1e-6, alpha_boundaries=(10000, 20000, 50000),
    alpha_values=(0.01, 0.1, 0.5, 1.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def pcn_tree(seed, coarse=COARSE, grid=GRID):
    return ae.autoencoder_init(
        torch.Generator().manual_seed(seed), 3, 1024, coarse * grid * grid,
        pcn.ENCODER_DIMS, (1024, 1024, 3 * coarse), "pcn", "folding",
        num_coarse=coarse, grid_size=grid, grid_scale=SCALE)


def targets(seed, bsz=B, n=N_GT, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(bsz, n, 3, generator=g) * 2 - 1).to(device)


def _step(params, state, gt, draws, count=0):
    """One ``ae_train_step`` from a fresh optimizer moved to ``count``
    updates; returns (loss, gradients by leaf, the optimizer)."""
    leaf = ref.leaves(params)
    opt, sched = steps.make_ae_optimizer(params, RECIPE, 1)
    sched.last_epoch = count
    _, m = steps.ae_train_step(
        params, state, opt, {"complete_pc": gt,
                             "pad": torch.zeros(gt.shape[0],
                                                device=gt.device)},
        draws, scheduler=sched, spec=SPEC, recon_loss="chamfer",
        bidirectional=True, alpha=RECIPE.alpha)
    return m["loss"], {k: v.grad for k, v in leaf.items()}, opt


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_forward_matches_the_reference():
    params, state = pcn_tree(1)
    pc = targets(2, n=N_IN)
    mask = (torch.arange(N_IN)[None] < torch.tensor([[40], [64]])).float()
    gfv, _ = ae.any_encoder_apply(params["encoder"], state["encoder"], pc,
                                  mask)
    coarse, fine = pcn.folding_decoder_outputs(params["decoder"],
                                               state["decoder"], gfv)
    want = ref.forward(params, pc, mask, GRID, SCALE)
    # the same products, the folding's first layer summed in another
    # order (its shared parts apart): equal within a few f32 roundings of
    # the largest element
    for k, got in (("gfv", gfv), ("coarse", coarse), ("fine", fine)):
        assert got.shape == want[k].shape
        assert _rel(got, want[k]) < 1e-6, k
    served, _ = ae.any_decoder_apply(params["decoder"], state["decoder"], gfv)
    assert torch.equal(served, fine)
    # a masked row changes neither pool
    pc2 = pc.clone()
    pc2[0, 50:] = 9.0
    gfv2, _ = ae.any_encoder_apply(params["encoder"], state["encoder"], pc2,
                                   mask)
    assert torch.equal(gfv2, gfv)


def test_published_widths_and_glorot_init():
    params, state = ae.autoencoder_init(
        torch.Generator().manual_seed(3), 3, 1024, 16384, pcn.ENCODER_DIMS,
        pcn.COARSE_DIMS, "pcn", "folding")
    flat = ref.leaves(params)
    assert sum(v.numel() for v in flat.values()) == 6_861_059
    for k, v in flat.items():
        if k.endswith(".b"):
            assert not v.any(), k
        else:
            bound = math.sqrt(6.0 / sum(v.shape))
            assert float(v.abs().max()) <= bound and \
                float(v.abs().max()) > 0.9 * bound, k
    assert [tuple(p["w"].shape) for p in params["decoder"]["folding"]] == [
        (1029, 512), (512, 512), (512, 3)]
    assert [tuple(p["w"].shape) for p in params["encoder"]["stage1"]] == [
        (512, 512), (512, 1024)]
    # linspace's rounding differs from the reference's by a last bit
    assert torch.allclose(state["decoder"]["grid"], ref.grid(4, 0.05),
                          rtol=0, atol=1e-8)
    assert state["encoder"] == {}


def _plain_dense(p, x):
    return x @ p["w"] + p["b"]


@pytest.mark.parametrize("grid", [2, 4])
@pytest.mark.parametrize("coarse", [8, 32])
def test_folding_in_float64_equals_the_concatenated_decoder(
        monkeypatch, grid, coarse):
    """The folding's first layer from its shared products against the
    reference's concatenation, in float64 on the same weights and grid:
    both outputs and the gradients of the GFV, the coarse cloud and every
    folding leaf agree to rounding, 1e-12 of the largest element.
    ``nn.dense`` accumulates in f32 whatever its inputs, so the plain
    product stands in for it on both sides."""
    monkeypatch.setattr(pcn.nn, "dense", _plain_dense)
    params, state = pcn_tree(21, coarse=coarse, grid=grid)
    dec = tree_map(lambda v: v.double().requires_grad_(True),
                   params["decoder"])
    gfv = targets(22, n=1024)[..., 0].double().requires_grad_(True)
    g = torch.Generator().manual_seed(23)
    d_coarse = torch.randn(B, coarse, 3, generator=g, dtype=torch.float64)
    d_fine = torch.randn(B, coarse * grid * grid, 3, generator=g,
                         dtype=torch.float64)
    folding = ref.leaves(dec["folding"])

    def outputs_and_grads(decode):
        out = decode()
        grads = torch.autograd.grad(
            (out[0] * d_coarse).sum() + (out[1] * d_fine).sum(),
            [gfv, out[0]] + list(folding.values()))
        return out, dict(zip(["gfv", "coarse"] + list(folding), grads))

    grid64 = ref.grid(grid, SCALE).double()
    got, got_grads = outputs_and_grads(lambda: pcn.folding_decoder_outputs(
        dec, {"grid": grid64}, gfv))
    want, want_grads = outputs_and_grads(
        lambda: ref.decoder(dec, gfv, grid, SCALE))
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape
        assert _rel(a.detach(), b.detach()) < 1e-12
    for k, want_grad in want_grads.items():
        assert _rel(got_grads[k], want_grad) < 1e-12, k


class _Shapes(torch.utils._python_dispatch.TorchDispatchMode):
    """The shape of every tensor each aten operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in
                        torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


def test_folding_never_builds_the_concatenated_input():
    """Neither the forward folding nor its backward returns a tensor 2 + 3
    + latent wide, or one of B C S rows of the GFV's width: the GFV's
    product is made once a cloud. The reference's concatenation trips the
    same check."""
    params, state = pcn_tree(24)
    dec = tree_map(lambda v: v.requires_grad_(True), params["decoder"])
    gfv = targets(25, n=1024)[..., 0].requires_grad_(True)
    latent, rows = gfv.shape[1], COARSE * GRID * GRID

    def concatenated(decode):
        with _Shapes() as seen:
            coarse, fine = decode()
            (coarse.sum() + fine.sum()).backward()
        return [s for s in seen.shapes if s and (
            s[-1] == 2 + 3 + latent
            or (s[-1] == latent and math.prod(s[:-1]) == B * rows))]

    assert concatenated(lambda: pcn.folding_decoder_outputs(
        dec, state["decoder"], gfv)) == []
    assert concatenated(lambda: ref.decoder(dec, gfv, GRID, SCALE))


def test_input_draws_subsample_the_target_then_cut_the_hole():
    gt = targets(4)
    g = torch.Generator().manual_seed(5)
    draws = pc_ops.draw_training_batch(g, B, N_GT, spec=SPEC,
                                       input_points=N_IN)
    # the contract: the subsample's scores first, then the holes over the
    # input's rows, and no augmentation
    again = torch.Generator().manual_seed(5)
    assert torch.equal(draws["subsample"], torch.rand(B, N_GT,
                                                      generator=again))
    assert torch.equal(draws["ratio"], 0.2 + 0.3 * torch.rand(
        B, generator=again))
    assert set(draws) == {"subsample", "ratio", "method", "rand_scores",
                          "center", "normal"}
    assert draws["rand_scores"].shape == (B, N_IN)
    complete, incomplete, mask = pc_ops.apply_training_batch(gt, draws,
                                                             spec=SPEC)
    assert torch.equal(complete, gt)
    assert incomplete.shape == (B, N_IN, 3) and mask.shape == (B, N_IN)
    keep = torch.floor(N_IN * (1 - draws["ratio"])).long()
    assert torch.equal(mask.sum(1).long(), keep)
    rows = torch.sort(draws["subsample"], dim=1, stable=True).indices[:, :N_IN]
    for i in range(B):
        kept = incomplete[i][mask[i] > 0]
        # every kept point is a distinct row of the drawn subsample, in
        # the target's frame
        hits = (kept[:, None] == gt[i][rows[i]][None]).all(-1)
        assert torch.equal(hits.sum(1), torch.ones(len(kept),
                                                   dtype=torch.long))
        assert len(set(hits.float().argmax(1).tolist())) == len(kept)


@pytest.fixture(scope="module")
def one_step():
    """One program step and the reference's loss and gradients on the same
    weights and inputs."""
    params, state = pcn_tree(6)
    params = tree_map(lambda v: v.requires_grad_(True), params)
    start = {k: v.detach().clone() for k, v in ref.leaves(params).items()}
    gt = targets(7)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(8), B,
                                       N_GT, spec=SPEC, input_points=N_IN)
    _, pc, mask = pc_ops.apply_training_batch(gt, draws, spec=SPEC)
    loss, grads, opt = _step(params, state, gt, draws)
    ref_params = tree_map(lambda v: v.detach().clone().requires_grad_(True),
                          params)
    for k, v in ref.leaves(ref_params).items():
        v.data.copy_(start[k])
    want_loss = ref.loss(ref_params, pc, mask, gt, 0, GRID, SCALE)
    want = ref.gradients(ref_params, pc, mask, gt, 0, GRID, SCALE)
    return dict(params=params, start=start, loss=loss, grads=grads, opt=opt,
                want_loss=want_loss, want=want)


def test_loss_matches_the_reference(one_step):
    # the CPU's plain nearest search takes |a|^2 + |b|^2 - 2 a.b in f32,
    # the reference the differences' squares: 1e-7 cancellation in a
    # squared distance of ~1e-2, relative 1e-5 in a distance
    got = float(one_step["loss"])
    want = float(one_step["want_loss"].detach())
    assert abs(got - want) <= 1e-5 * want


@pytest.mark.parametrize("part", ["encoder.stage0", "encoder.stage1",
                                  "decoder.coarse", "decoder.folding"])
def test_each_leaf_gradient_matches_the_reference(one_step, part):
    # the same 1e-5 of the distances carries into g / dist in the gradient
    # (K4's plain version divides by the identity's distance); 1e-4 of
    # the leaf's largest element leaves a 10x margin
    keys = [k for k in one_step["want"] if k.startswith(part)]
    assert keys
    for k in keys:
        assert _rel(one_step["grads"][k], one_step["want"][k]) < 1e-4, k


def test_one_adam_update_matches_the_reference(one_step):
    """The program's update from its own gradient against the reference's
    Adam fed that gradient: the same float32 arithmetic, to within a few
    roundings of the update's size (lr)."""
    grads = one_step["grads"]
    zeros = {k: torch.zeros_like(v) for k, v in grads.items()}
    want = ref.adam_update(one_step["start"], grads, zeros,
                           {k: torch.zeros_like(v) for k, v in grads.items()},
                           0, ref.learning_rate(0))
    got = {k: v.detach() for k, v in ref.leaves(one_step["params"]).items()}
    for k in want:
        step = got[k] - one_step["start"][k]
        assert float((step - (want[k] - one_step["start"][k])).abs().max()) \
            <= 1e-3 * ref.learning_rate(0), k
    # Adam's first update moves every element with a gradient by about lr
    w = "decoder.folding.0.w"
    moved = (got[w] - one_step["start"][w]).abs()
    assert float(moved.max()) <= 1.001e-4 and float(moved.max()) > 0.9e-4


@pytest.mark.parametrize("count,alpha,lr", [
    (0, 0.01, 1e-4), (9_999, 0.01, 1e-4), (10_000, 0.01, 1e-4),
    (10_001, 0.1, 1e-4), (50_000, 0.5, 0.7e-4), (50_001, 1.0, 0.7e-4),
    (1_000_000, 1.0, 1e-6)])
def test_alpha_and_learning_rate_schedules(count, alpha, lr):
    assert RECIPE.alpha(count) == ref.alpha(count) == alpha
    params, _ = pcn_tree(9, coarse=4, grid=1)
    _, sched = steps.make_ae_optimizer(params, RECIPE, 7)
    got = RECIPE.lr * sched.lr_lambdas[0](count)
    assert math.isclose(got, ref.learning_rate(count), rel_tol=1e-12)
    assert math.isclose(got, lr, rel_tol=1e-12)


def test_config_fields_load_and_validate():
    c = cfg_lib.load_config(str(ROOT / "configs" / "config_pcn.yaml"))
    a, t = c.model.autoencoder, c.training.autoencoder
    assert (a.encoder_type, a.decoder_type, a.num_coarse, a.grid_size,
            a.grid_scale, a.input_points, a.num_points, a.latent_dim) == (
        "pcn", "folding", 1024, 4, 0.05, 2048, 16384, 1024)
    assert (t.lr_schedule, t.lr, t.scheduler_gamma, t.decay_steps,
            t.lr_floor, t.batch_size) == ("staircase", 1e-4, 0.7, 50000,
                                          1e-6, 32)
    assert [t.alpha(k) for k in (0, 10_001, 20_001, 50_001)] == [
        0.01, 0.1, 0.5, 1.0]
    base = cfg_lib.AutoencoderModelConfig
    for bad in (dict(encoder_type="pcnn"), dict(decoder_type="fold"),
                dict(decoder_type="folding", num_coarse=100),
                dict(decoder_type="folding", grid_size=0),
                dict(input_points=4096), dict(input_points=-1)):
        with pytest.raises(ValueError):
            base(**bad)
    for bad in (dict(lr_schedule="exponential"), dict(decay_steps=0),
                dict(lr_floor=-1.0), dict(alpha_boundaries=(5,)),
                dict(alpha_boundaries=(5, 5), alpha_values=(1., 1., 1.)),
                dict(alpha_values=(-1.0,))):
        with pytest.raises(ValueError):
            cfg_lib.AETrainConfig(**bad)
    with pytest.raises(ValueError, match="frame"):
        cfg_lib.load_config(None, overrides={
            "model": {"autoencoder": {"input_points": 1024}}})


def _tiny_config(tmp_path=None):
    raw = {"model": {"autoencoder": {
        "latent_dim": 1024, "num_points": N_GT, "encoder_type": "pcn",
        "encoder_dims": [128, 256, 512, 1024], "decoder_type": "folding",
        "decoder_dims": [64, 3 * COARSE], "num_coarse": COARSE,
        "grid_size": GRID, "input_points": N_IN},
        "lgan": {"z_dim": 2, "latent_dim": 1024,
                 "generator_dims": [32, 1024],
                 "discriminator_dims": [32, 1]},
        "rl_agent": {"state_dim": 1024, "action_dim": 2,
                     "hidden_dims": [32, 32, 32]}},
        "training": {"precision": "float32", "batch_size": 4,
                     "autoencoder": {"epochs": 1, "lr": 1e-4,
                                     "lr_schedule": "staircase",
                                     "scheduler_gamma": 0.7,
                                     "alpha_boundaries": [1],
                                     "alpha_values": [0.5, 1.0]}},
        "data": {"normalize": False, "center": False, "unit_sphere": False,
                 "augmentation": {"rotation": False, "jitter": False,
                                  "scale": False}}}
    if tmp_path is not None:
        raw["training"].update(checkpoint_dir=str(tmp_path / "ckpt"),
                               log_dir=str(tmp_path / "logs"),
                               results_dir=str(tmp_path / "results"))
        raw["data"]["data_dir"] = str(tmp_path / "data")
        raw["logging"] = {"use_tensorboard": False}
    return raw


def test_complete_serves_the_fine_cloud_and_engines_refuse_it():
    c = cfg_lib.load_config(None, overrides=_tiny_config())
    model = net.init_model(torch.Generator().manual_seed(10), c)
    pc = targets(11, bsz=3, n=N_IN)
    mask = torch.ones(3, N_IN)
    out = net.complete(model, pc, mask, cfg=c.td3_config())
    for k in ("completed_pc", "ae_reconstruction", "hybrid_output"):
        assert out[k].shape == (3, COARSE * GRID * GRID, 3), k
    assert out["noisy_gfv"].shape == (3, 1024)
    want = ref.forward(model["ae"]["params"], pc, mask, GRID, SCALE)
    assert _rel(out["ae_reconstruction"], want["fine"]) < 1e-6
    with pytest.raises(ValueError, match="PCN"):
        inference.prepare_inference_engine(model)


@pytest.mark.parametrize("w_ae_recon", [0.0, 0.3])
def test_joint_step_trains_the_folding_loss(w_ae_recon):
    """The joint step's Chamfer terms are PCN's, CD(coarse) + w CD(fine),
    of the completion decode(G(actor(GFV))) and, with ``w_ae_recon``, of
    the reconstruction decode(GFV), on PCN's input."""
    c = cfg_lib.load_config(None, overrides=_tiny_config())
    model = net.init_model(torch.Generator().manual_seed(16), c)
    ref_params = tree_map(lambda v: v.detach().clone(), model["ae"]["params"])
    gen = tree_map(lambda v: v.detach().clone(),
                   (model["lgan"]["params"]["generator"],
                    model["lgan"]["state"]["generator"]))
    trainable = steps.joint_trainable(model)
    for v in tree_leaves(trainable):
        v.requires_grad_(True)
    gt = targets(17)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(18), B,
                                       N_GT, spec=SPEC, input_points=N_IN)
    fine_weight = 0.5
    _, m = steps.joint_train_step(
        model, steps.make_joint_optimizer(trainable, c.training.joint),
        {"complete_pc": gt, "pad": torch.zeros(B)}, draws,
        cfg=c.td3_config(), spec=SPEC, w_ae_recon=w_ae_recon,
        fine_weight=fine_weight)
    _, pc, mask = pc_ops.apply_training_batch(gt, draws, spec=SPEC)
    assert pc.shape == (B, N_IN, 3)
    with torch.no_grad():
        noisy = ref.encoder(ref_params["encoder"], pc, mask)
        actor = model["agent"]["actor"]
        z, _ = rl.actor_apply(actor["params"], actor["state"], noisy,
                                  cfg=c.td3_config())
        clean, _ = lg.generator_apply(*gen, z, training=True)

        def want(gfv):
            coarse, fine = ref.decoder(ref_params["decoder"], gfv, GRID,
                                       SCALE)
            return float((ref.chamfer(coarse, gt)
                          + fine_weight * ref.chamfer(fine, gt)).mean())

        want_ch = want(clean)
        want_loss = want_ch + 0.1 * float(m["gfv"]) + w_ae_recon * want(noisy)
    # the loss test's 1e-5 of the distances, from the nearest search
    assert abs(float(m["chamfer"]) - want_ch) <= 1e-5 * want_ch
    assert abs(float(m["loss"]) - want_loss) <= 1e-5 * want_loss


def test_every_phase_feeds_the_encoder_pcn_inputs(tmp_path, monkeypatch):
    """Phases 1-5.5 and the evaluation CLI on a tiny PCN: every encoder
    call, the clean GFVs and the RL targets' included, sees
    ``input_points`` rows, never the target's."""
    raw = _tiny_config(tmp_path)
    raw["model"]["rl_agent"].update(buffer_size=16, batch_size=4)
    raw["training"].update(
        lgan={"epochs": 1, "batch_size": 4, "d_steps": 1},
        rl_agent={"episodes": 8, "envs_per_step": 4,
                  "start_training_steps": 4, "updates_per_step": 1},
        joint={"epochs": 1, "w_ae_recon": 0.5, "refresh_d_steps": 2,
               "calibrate_gate": True})
    setup_dataset(str(tmp_path / "data"), synthetic=True,
                  samples_per_category=2, num_points=N_GT)
    (tmp_path / "tiny.json").write_text(json.dumps(raw))
    rows = []
    encoder = pcn.pcn_encoder_apply

    def spy(params, state, pc, mask=None):
        rows.append(pc.shape[1])
        return encoder(params, state, pc, mask)

    monkeypatch.setattr(pcn, "pcn_encoder_apply", spy)
    trainer = RLGANNetTrainer(str(tmp_path / "tiny.json"), device="cpu")
    try:
        assert math.isfinite(trainer.train_autoencoder(1))
        trainer.generate_gfvs()
        assert trainer.gfvs["clean"].shape[1] == 1024
        assert math.isfinite(trainer.train_latent_gan(1))
        assert math.isfinite(trainer.train_rl_agent(8))
        assert math.isfinite(trainer.joint_training(1))
        trainer.post_joint_refresh()
    finally:
        trainer.close()
    assert (tmp_path / "ckpt" / "joint_calibrated").exists()
    stats = evaluate.main(["--config", str(tmp_path / "tiny.json"),
                           "--checkpoint", "joint_calibrated", "--device",
                           "cpu", "--metrics", "chamfer_distance",
                           "--num-export", "0"])
    assert math.isfinite(stats["chamfer_distance"])
    assert rows and set(rows) == {N_IN}


def test_step_spans_hold_the_folding_inside_the_decoder():
    params, state = pcn_tree(12)
    params = tree_map(lambda v: v.requires_grad_(True), params)
    gt = targets(13)
    draws = pc_ops.draw_training_batch(torch.Generator().manual_seed(14), B,
                                       N_GT, spec=SPEC, input_points=N_IN)
    profiling.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _step(params, state, gt, draws)
        records = profiling.span_records()
    finally:
        profiling.clear_spans()
    parents = {r["name"]: r["parent"] for r in records if "phase" not in r}
    assert parents["ae.folding"] == "ae.decoder"
    back = [r["name"] for r in records if r.get("phase") == "backward"]
    assert back == ["ae.chamfer", "ae.folding", "ae.decoder", "ae.encoder"]


def test_cli_trains_phase_one(tmp_path):
    setup_dataset(str(tmp_path / "data"), synthetic=True,
                  samples_per_category=2, num_points=N_GT)
    (tmp_path / "tiny.json").write_text(json.dumps(_tiny_config(tmp_path)))
    res = subprocess.run(
        [sys.executable, "-m", "gan_rl_3d_tpu_torch.train_rl_gan_net",
         "--config", str(tmp_path / "tiny.json"), "--phase", "autoencoder",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert "AE epoch 1/1 train" in res.stdout
    assert (tmp_path / "ckpt" / "autoencoder_best").exists()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_published_widths_step_matches_the_reference_on_card(cuda):
    """One step at B=4, 2,048-row inputs, 16,384-point targets and 1,024
    coarse points on the card against the reference there (f32, TF32
    off): the loss, every leaf's gradient and the update; the step runs
    four K3 launches and four K4 (two a Chamfer term each) and two K5
    (the target needs no gradient)."""
    params, state = ae.autoencoder_init(
        torch.Generator().manual_seed(15), 3, 1024, 16384, pcn.ENCODER_DIMS,
        pcn.COARSE_DIMS, "pcn", "folding")
    params = tree_map(lambda v: v.to(cuda).requires_grad_(True), params)
    state = tree_map(lambda v: v.to(cuda), state)
    start = {k: v.detach().clone() for k, v in ref.leaves(params).items()}
    gt = targets(16, bsz=4, n=16384, device=cuda)
    draws = pc_ops.draw_training_batch(
        torch.Generator(cuda).manual_seed(17), 4, 16384, spec=SPEC,
        input_points=2048)
    _, pc, mask = pc_ops.apply_training_batch(gt, draws, spec=SPEC)
    before = _cuda.launch_counts.copy()
    loss, grads, _ = _step(params, state, gt, draws)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["nn_dist"] - before["nn_dist"] == 4
    assert _cuda.launch_counts["nn_gather"] - before["nn_gather"] == 4
    assert _cuda.launch_counts["nn_scatter"] - before["nn_scatter"] == 2
    ref_params = tree_map(lambda v: v.detach().clone().requires_grad_(True),
                          params)
    for k, v in ref.leaves(ref_params).items():
        v.data.copy_(start[k])
    want_loss = float(ref.loss(ref_params, pc, mask, gt, 0, 4, 0.05))
    want = ref.gradients(ref_params, pc, mask, gt, 0, 4, 0.05)
    # K3 takes the differences' squares, as the reference does; the sums
    # run in other orders: a few f32 roundings of the loss
    assert abs(float(loss) - want_loss) <= 2e-6 * want_loss
    # near-ties among 16,384 points pick other neighbours on either side
    # in a few rows: 1e-2 of a leaf's largest element, against ~1 from a
    # lower precision or a wrong term
    for k in want:
        assert _rel(grads[k], want[k]) < 1e-2, k
    got = {k: v.detach() for k, v in ref.leaves(params).items()}
    zeros = {k: torch.zeros_like(v) for k, v in grads.items()}
    new = ref.adam_update(start, grads, zeros,
                          {k: torch.zeros_like(v) for k, v in grads.items()},
                          0, 1e-4)
    for k in new:
        assert float((got[k] - new[k]).abs().max()) <= 1e-7, k


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(16384, 16384), (1024, 16384),
                                 (16384, 1024)])
def test_chamfer_kernels_match_their_plain_versions_at_pcn_sizes(cuda, n, m):
    """K3 (distances and indices), K4 and K5 against the plain versions
    at PCN's sizes, the coarse cloud's and the fine one's against a
    16,384-point target both ways, one launch each."""
    a = targets(18, bsz=2, n=n, device=cuda) * 0.5
    b = targets(19, bsz=2, n=m, device=cuda) * 0.5
    before = _cuda.launch_counts.copy()
    dist, idx = chamfer._nearest_forward(a, b, None)
    g = targets(20, bsz=2, n=n, device=cuda)[..., 0]
    da = chamfer.nearest_grad_a(a, b, idx, dist, g)
    db = chamfer.nearest_grad_b(idx, da, m)
    torch.cuda.synchronize()
    for name in ("nn_dist", "nn_gather", "nn_scatter"):
        assert _cuda.launch_counts[name] - before[name] == 1, name
    rd, ri = chamfer.nearest_distances_plain(a, b)
    # both take |a|^2 + |b|^2 - 2 a.b in f32 (the existing K3 tests'
    # 1e-3), and pick the same neighbour wherever the two nearest squared
    # distances lie 1e-4 apart
    assert float((dist - rd).abs().max()) <= 1e-3
    top2 = chamfer._sqdist(a, b, None).topk(2, dim=-1, largest=False).values
    settled = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert bool(((idx == ri) | ~settled).all())
    # K4 divides as its plain version does up to the last bit (the
    # existing K4 tests' 1e-5); K5 adds in the plain version's order
    want_da = chamfer.nearest_grad_a_plain(a, b, idx, dist, g)
    assert _rel(da, want_da) <= 1e-5
    assert torch.equal(db, chamfer.nearest_grad_b_plain(idx, da, m))
