"""Plain float32 reference of PCN (Yuan et al., 3DV 2018, arXiv:1808.00671)
as github.com/wentaoyuan/pcn writes it in ``models/pcn_cd.py`` and
``train.py``: the two-stage encoder, the coarse MLP, the folding, the
Chamfer loss of both outputs, its gradients by autograd, and Adam with the
staircase learning rate and the alpha schedule. Plain ``torch`` alone: no
JAX, no module of the JAX package or of its port. TF32 is off for matrix
products and convolutions.

Departures from ``pcn_cd.py``:
* the loss is the CD variant (``pcn_cd``), not EMD (``pcn_emd``);
* the input is a fixed number of rows with a mask (rows the mask marks 0
  are padding and take no part in either max pool) instead of PCN's
  ragged batch of partial scans;
* a nearest-neighbour distance under 1e-6 gets no gradient (sqrt of the
  squared distance clamped at 1e-12), where TF's sqrt would return
  inf/NaN at 0;
* Adam adds its epsilon after the bias correction of the second moment,
  as ``torch.optim.Adam`` does (TF's AdamOptimizer adds it before: the
  two differ by under eps * sqrt(1 - beta2^t) in the denominator);
* the data are synthetic clouds; the weights are the caller's (PCN draws
  Glorot-uniform weights and zero biases).

Parameters are dictionaries in the port's layout: ``encoder`` holds
``stage0`` and ``stage1``, ``decoder`` holds ``coarse`` and ``folding``,
each a list of ``{"w": (in, out), "b": (out,)}`` layers.
"""

import math
from typing import Dict, List

import torch

Tensor = torch.Tensor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ALPHA_BOUNDARIES = (10000, 20000, 50000)
ALPHA_VALUES = (0.01, 0.1, 0.5, 1.0)
BASE_LR, DECAY_STEPS, DECAY_RATE, LR_CLIP = 1e-4, 50000, 0.7, 1e-6


def mlp(layers: List[dict], x: Tensor) -> Tensor:
    """``mlp`` / ``mlp_conv`` of PCN's tf_util: ReLU after every layer but
    the last."""
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def point_maxpool(x: Tensor, mask: Tensor) -> Tensor:
    """Max over each cloud's kept rows."""
    return torch.stack([x[i][mask[i] > 0].max(dim=0).values
                        for i in range(x.shape[0])])


def encoder(params: dict, pc: Tensor, mask: Tensor) -> Tensor:
    """``create_encoder``: the GFV (B, 1024)."""
    f = mlp(params["stage0"], pc)
    g0 = point_maxpool(f, mask)
    tiled = g0[:, None, :].repeat(1, pc.shape[1], 1)
    return point_maxpool(mlp(params["stage1"], torch.cat([f, tiled], 2)),
                         mask)


def grid(size: int, scale: float) -> Tensor:
    """``tf.meshgrid(t, t)`` (``xy`` indexing) stacked on axis 2 and
    reshaped to (size^2, 2): row i size + j is (t[j], t[i])."""
    t = [-scale + 2.0 * scale * k / (size - 1) for k in range(size)] \
        if size > 1 else [-scale]
    return torch.tensor([[t[j], t[i]] for i in range(size)
                         for j in range(size)], dtype=torch.float32)


def decoder(params: dict, v: Tensor, grid_size: int, grid_scale: float):
    """``create_decoder``: (coarse (B, C, 3), fine (B, C S, 3))."""
    bsz = v.shape[0]
    coarse = mlp(params["coarse"], v).reshape(bsz, -1, 3)
    c, s = coarse.shape[1], grid_size ** 2
    grid_feat = grid(grid_size, grid_scale).to(v.device)[None].repeat(
        bsz, c, 1)
    point_feat = coarse[:, :, None, :].repeat(1, 1, s, 1).reshape(
        bsz, c * s, 3)
    global_feat = v[:, None, :].repeat(1, c * s, 1)
    feat = torch.cat([grid_feat, point_feat, global_feat], 2)
    return coarse, mlp(params["folding"], feat) + point_feat


@torch.no_grad()
def nearest_index(a: Tensor, b: Tensor, rows: int = 4096) -> Tensor:
    """Index into ``b`` (B, M, 3) of each point of ``a`` (B, N, 3)'s
    nearest neighbour, by brute force over blocks of ``rows`` points of one
    cloud: squared distances in float64, the first index of the least."""
    out = torch.empty(a.shape[:2], dtype=torch.long, device=a.device)
    for i in range(a.shape[0]):
        b64 = b[i].double()
        for r in range(0, a.shape[1], rows):
            d2 = (a[i, r:r + rows].double()[:, None, :] - b64[None]) \
                .square().sum(-1)
            out[i, r:r + rows] = d2.argmin(dim=1)
    return out


def nearest_dist(a: Tensor, b: Tensor) -> Tensor:
    near = torch.gather(b, 1, nearest_index(a, b)[..., None].expand(-1, -1,
                                                                    3))
    return torch.sqrt(torch.clamp((a - near).square().sum(-1), min=1e-12))


def chamfer(a: Tensor, b: Tensor) -> Tensor:
    """PCN's ``chamfer`` per cloud (B,): the means of the unsquared
    nearest distances both ways, halved."""
    return (nearest_dist(a, b).mean(1) + nearest_dist(b, a).mean(1)) / 2.0


def alpha(count: int) -> float:
    """``tf.train.piecewise_constant(global_step, [10k, 20k, 50k],
    [0.01, 0.1, 0.5, 1.0])`` at the update after ``count`` updates."""
    for boundary, value in zip(ALPHA_BOUNDARIES, ALPHA_VALUES):
        if count <= boundary:
            return value
    return ALPHA_VALUES[-1]


def learning_rate(count: int, base: float = BASE_LR) -> float:
    """``exponential_decay(base, step, 50000, 0.7, staircase=True)``,
    then ``tf.maximum(lr, 1e-6)``."""
    return max(base * DECAY_RATE ** (count // DECAY_STEPS), LR_CLIP)


def forward(params: dict, pc: Tensor, mask: Tensor, grid_size: int,
            grid_scale: float) -> Dict[str, Tensor]:
    v = encoder(params["encoder"], pc, mask)
    coarse, fine = decoder(params["decoder"], v, grid_size, grid_scale)
    return {"gfv": v, "coarse": coarse, "fine": fine}


def loss(params: dict, pc: Tensor, mask: Tensor, gt: Tensor, count: int,
         grid_size: int, grid_scale: float) -> Tensor:
    """``loss_coarse + alpha * loss_fine``, each the batch mean of
    ``chamfer``."""
    out = forward(params, pc, mask, grid_size, grid_scale)
    return chamfer(out["coarse"], gt).mean() \
        + alpha(count) * chamfer(out["fine"], gt).mean()


def leaves(tree, path=()) -> Dict[str, Tensor]:
    """Tensors of ``tree`` by dotted path."""
    if isinstance(tree, Tensor):
        return {".".join(map(str, path)): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(leaves(v, path + (k,)))
    return out


def gradients(params: dict, *args) -> Dict[str, Tensor]:
    """Each leaf's gradient of ``loss(params, *args)``."""
    flat = leaves(params)
    grads = torch.autograd.grad(loss(params, *args), list(flat.values()))
    return dict(zip(flat, grads))


@torch.no_grad()
def adam_update(params: Dict[str, Tensor], grads: Dict[str, Tensor],
                m: Dict[str, Tensor], v: Dict[str, Tensor], count: int,
                lr: float, betas=(0.9, 0.999), eps: float = 1e-8
                ) -> Dict[str, Tensor]:
    """One Adam update (``tf.train.AdamOptimizer``'s default betas and
    epsilon, in torch's form) of the flat ``params`` at update ``count +
    1``; ``m`` and ``v`` are updated in place. Returns the new
    parameters."""
    b1, b2 = betas
    t = count + 1
    out = {}
    for k, p in params.items():
        m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
        v[k].mul_(b2).add_(grads[k].square(), alpha=1 - b2)
        denom = v[k].sqrt() / math.sqrt(1 - b2 ** t) + eps
        out[k] = p - lr / (1 - b1 ** t) * m[k] / denom
    return out
