"""Plain PCN training steps (Yuan et al., 3DV 2018, arXiv:1808.00671;
github.com/wentaoyuan/pcn ``models/pcn_cd.py``, ``train.py``): each step's
draws replayed from the benchmark's generator, the input drawn from the
target and holed, the two-stage encoder, the coarse MLP and the folding
written out, the Chamfer loss of both outputs weighted by alpha, its
gradient by autograd, and Adam with the staircase learning rate.

Departures from ``pcn_cd.py``, as in the tests' copy of this reference:
the CD variant; a fixed number of input rows with a mask instead of
ragged partial scans; no gradient through a nearest distance under 1e-6;
Adam's epsilon after the bias correction (torch's form); synthetic data.
The nearest neighbours are found by brute force in float64, over blocks
of one cloud's rows.
"""

import math
from typing import Dict, List

import torch

from perfbench.reference import nets
from perfbench.reference import train as ref_train

Tensor = torch.Tensor
# squared distances a block of the nearest-neighbour search holds
BLOCK = 1 << 26


def draw_step(g: torch.Generator, bsz: int, gt_points: int,
              input_points: int, hole_min: float, hole_max: float
              ) -> Dict[str, Tensor]:
    """One step's random numbers in the order and shapes the program draws
    them from the same generator: the subsample's scores over the target,
    then over the input's rows the hole ratio, method, random-drop scores,
    sphere centre and plane normal (unused); nothing for augmentation."""
    kw = dict(generator=g, device=g.device)
    return {"subsample": torch.rand((bsz, gt_points), **kw),
            "ratio": hole_min + (hole_max - hole_min) * torch.rand(bsz, **kw),
            "method": torch.randint(0, len(ref_train.HOLE_METHODS), (bsz,),
                                    **kw),
            "scores": torch.rand((bsz, input_points), **kw),
            "center": torch.randint(0, input_points, (bsz,), **kw),
            "normal": torch.randn((bsz, 3), **kw)}


def prepare(complete: Tensor, d: Dict[str, Tensor]):
    """(input, mask): the rows of the ``input_points`` lowest subsample
    scores (ties by position), then the hole cut from them; the target's
    frame."""
    n_in = d["scores"].shape[1]
    rows = torch.sort(d["subsample"], dim=1, stable=True).indices[:, :n_in]
    source = complete.gather(1, rows[..., None].expand(-1, -1, 3))
    return ref_train.cut_holes(source, d)


def mlp(layers: List[dict], x: Tensor) -> Tensor:
    """ReLU after every dense layer but the last."""
    for i, p in enumerate(layers):
        x = nets.dense(p, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def pool(x: Tensor, mask: Tensor) -> Tensor:
    """Max over each cloud's kept rows."""
    return torch.where(mask[..., None] > 0, x, -math.inf).amax(dim=1)


def grid(size: int, scale: float) -> Tensor:
    """Row i size + j is (t[j], t[i]), t evenly spaced over [-scale,
    scale] (TF's meshgrid in ``xy`` order)."""
    t = [-scale + 2.0 * scale * k / (size - 1) for k in range(size)]
    return torch.tensor([[t[j], t[i]] for i in range(size)
                         for j in range(size)], dtype=torch.float32)


def forward(params: dict, pc: Tensor, mask: Tensor, grid_size: int,
            grid_scale: float):
    """(coarse (B, C, 3), fine (B, C S, 3))."""
    enc, dec = params["encoder"], params["decoder"]
    f = mlp(enc["stage0"], pc)
    tiled = pool(f, mask)[:, None, :].expand(-1, pc.shape[1], -1)
    v = pool(mlp(enc["stage1"], torch.cat([f, tiled], 2)), mask)
    bsz = v.shape[0]
    coarse = mlp(dec["coarse"], v).reshape(bsz, -1, 3)
    c, s = coarse.shape[1], grid_size ** 2
    grid_feat = grid(grid_size, grid_scale).to(v.device)[None].expand(
        bsz, s, 2).repeat(1, c, 1)
    centre = coarse[:, :, None, :].expand(-1, -1, s, -1).reshape(bsz, c * s,
                                                                 3)
    feat = torch.cat([grid_feat, centre,
                      v[:, None, :].expand(-1, c * s, -1)], 2)
    return coarse, mlp(dec["folding"], feat) + centre


@torch.no_grad()
def nearest_index(a: Tensor, b: Tensor) -> Tensor:
    """Index into ``b`` (B, M, 3) of each point of ``a`` (B, N, 3)'s nearest
    neighbour, the first among equal squared distances, in float64."""
    out = torch.empty(a.shape[:2], dtype=torch.long, device=a.device)
    rows = max(1, BLOCK // b.shape[1])
    for i in range(a.shape[0]):
        b64 = b[i].double()
        b2 = (b64 * b64).sum(-1)[None]
        for r in range(0, a.shape[1], rows):
            a64 = a[i, r:r + rows].double()
            d2 = (a64 * a64).sum(-1)[:, None] + b2 - 2.0 * a64 @ b64.T
            out[i, r:r + rows] = d2.argmin(dim=1)
    return out


def chamfer(a: Tensor, b: Tensor) -> Tensor:
    """Per-cloud bidirectional Chamfer distance (B,): the unsquared
    nearest distances' means both ways, halved; clamped at 1e-12 before
    the square root."""
    def dist(p, q):
        near = torch.gather(q, 1, nearest_index(p, q)[..., None]
                            .expand(-1, -1, 3))
        return torch.sqrt(torch.clamp((p - near).square().sum(-1),
                                      min=1e-12))

    return (dist(a, b).mean(1) + dist(b, a).mean(1)) / 2.0


def alpha(count: int, opt: dict) -> float:
    """The fine term's weight at the update after ``count`` updates
    (tf.train.piecewise_constant: a boundary belongs to the value
    before it)."""
    for boundary, value in zip(opt["alpha_boundaries"], opt["alpha_values"]):
        if count <= boundary:
            return value
    return opt["alpha_values"][-1]


def learning_rate(count: int, opt: dict) -> float:
    """max(lr 0.7^(count // 50000), 1e-6), as the configuration states
    it."""
    return max(opt["lr"] * opt["scheduler_gamma"]
               ** (count // opt["decay_steps"]), opt["lr_floor"])


def train_steps(params: dict, batches: List[Tensor], g: torch.Generator,
                cfg: dict, input_points: int) -> dict:
    """One step per batch of targets from ``params`` (copied, not changed).
    Returns the losses, each leaf's first gradient and the parameters after
    the last step, by leaf path."""
    ae = cfg["model"]["autoencoder"]
    opt, data = cfg["training"]["autoencoder"], cfg["data"]
    b1, b2 = opt["betas"]
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in nets.leaves(params)}
    tree = ref_train._rebuild(params, p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for t, gt in enumerate(batches, start=1):
        d = draw_step(g, gt.shape[0], gt.shape[1], input_points,
                      data["hole_min_ratio"], data["hole_max_ratio"])
        pc, mask = prepare(gt, d)
        coarse, fine = forward(tree, pc, mask, ae["grid_size"],
                               ae["grid_scale"])
        loss = chamfer(coarse, gt).mean() \
            + alpha(t - 1, opt) * chamfer(fine, gt).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(loss.detach())
        lr = learning_rate(t - 1, opt)
        with torch.no_grad():
            gd = {k: gr + opt["weight_decay"] * p[k]
                  for k, gr in zip(p, grads)}
            if first_grad is None:
                first_grad = {k: gr.clone() for k, gr in zip(p, grads)}
            for k, x in p.items():
                m[k].mul_(b1).add_(gd[k], alpha=1 - b1)
                v2[k].mul_(b2).add_(gd[k].square(), alpha=1 - b2)
                denom = v2[k].sqrt() / math.sqrt(1 - b2 ** t) + opt["eps"]
                x.sub_(lr / (1 - b1 ** t) * m[k] / denom)
        del grads, gd, coarse, fine, loss
    return {"losses": torch.stack(losses), "first_grad": first_grad,
            "params": {k: x.detach() for k, x in p.items()}}
