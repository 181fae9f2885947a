"""Plain autoencoder training steps: the random draws of each step replayed
from the benchmark's generator, hole cutting, augmentation and
normalisation, the forward pass with training BatchNorm, the Chamfer loss,
its gradient by autograd, and Adam with L2 weight decay and a step
schedule, written out."""

import math
from typing import Dict, List

import torch

from perfbench.reference import chamfer, nets

Tensor = torch.Tensor
HOLE_METHODS = ("random", "sphere")


def draw_step(g: torch.Generator, bsz: int, n: int, hole_min: float,
              hole_max: float) -> Dict[str, Tensor]:
    """One step's random numbers, drawn in the order and shapes that the
    training step draws them from the same generator: hole ratio, hole
    method, random-drop scores, sphere centre, plane normal (unused by the
    two methods), then the augmentation triggers, Euler angles, jitter and
    scale."""
    kw = dict(generator=g, device=g.device)
    return {"ratio": hole_min + (hole_max - hole_min) * torch.rand(bsz, **kw),
            "method": torch.randint(0, len(HOLE_METHODS), (bsz,), **kw),
            "scores": torch.rand((bsz, n), **kw),
            "center": torch.randint(0, n, (bsz,), **kw),
            "normal": torch.randn((bsz, 3), **kw),
            "triggers": torch.rand((bsz, 3), **kw),
            "angles": 2.0 * math.pi * torch.rand((bsz, 3), **kw),
            "jitter": torch.randn((bsz, n, 3), **kw),
            "scale": 0.8 + 0.4 * torch.rand(bsz, **kw)}


def cut_holes(pc: Tensor, d: Dict[str, Tensor]):
    """Keep the floor(N (1 - ratio)) points of lowest score (random drop:
    the drawn scores; sphere: minus the distance to the centre point), in
    order of score, ties by position; slot i past them repeats kept point
    i mod n_keep. Returns (cloud, mask)."""
    bsz, n, _ = pc.shape
    centre = pc[torch.arange(bsz, device=pc.device), d["center"]][:, None]
    sphere = -(pc - centre).square().sum(-1).sqrt()
    score = torch.where(d["method"][:, None] == 0, d["scores"], sphere)
    order = torch.sort(score, dim=1, stable=True).indices
    n_keep = torch.floor(n * (1.0 - d["ratio"])).long()
    slots = torch.arange(n, device=pc.device)[None]
    src = order.gather(1, slots % n_keep[:, None])
    cloud = pc.gather(1, src[..., None].expand(-1, -1, 3))
    return cloud, (slots < n_keep[:, None]).float()


def rotation(angles: Tensor) -> Tensor:
    """Rz @ Ry @ Rx for Euler angles (B, 3)."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat((one, zero, zero), (zero, c[:, 0], -s[:, 0]),
             (zero, s[:, 0], c[:, 0]))
    ry = mat((c[:, 1], zero, s[:, 1]), (zero, one, zero),
             (-s[:, 1], zero, c[:, 1]))
    rz = mat((c[:, 2], -s[:, 2], zero), (s[:, 2], c[:, 2], zero),
             (zero, zero, one))
    return rz @ ry @ rx


def augment(pc: Tensor, d: Dict[str, Tensor], aug: dict) -> Tensor:
    """Rotate (p 0.5), jitter (p 0.5; sigma 0.01 clipped at 0.05, the same
    noise slot by slot) and scale (p 0.3) each cloud, where enabled."""
    fire = [(d["triggers"][:, k] < p)[:, None, None]
            for k, p in enumerate((0.5 if aug["rotation"] else 0.0,
                                   0.5 if aug["jitter"] else 0.0,
                                   0.3 if aug["scale"] else 0.0))]
    pc = torch.where(fire[0], pc @ rotation(d["angles"]).transpose(1, 2), pc)
    pc = torch.where(fire[1],
                     pc + torch.clamp(0.01 * d["jitter"], -0.05, 0.05), pc)
    return torch.where(fire[2], pc * d["scale"][:, None, None], pc)


def unit_sphere(pc: Tensor, mask=None) -> Tensor:
    """Centre on the (kept points') centroid, then scale the largest kept
    radius to 1."""
    w = torch.ones_like(pc[..., 0]) if mask is None else mask
    centroid = (pc * w[..., None]).sum(1, keepdim=True) \
        / torch.clamp(w.sum(1), min=1.0)[:, None, None]
    pc = pc - centroid
    radius = (pc.square().sum(-1).sqrt() * w).amax(dim=1)[:, None, None]
    return torch.where(radius > 0, pc / torch.where(radius > 0, radius, 1.0),
                       pc)


def prepare(complete: Tensor, d: Dict[str, Tensor], data: dict):
    """(complete, incomplete, mask) as the step trains on them."""
    if not (data["normalize"] and data["center"] and data["unit_sphere"]):
        raise ValueError("the reference normalises to the unit sphere only")
    incomplete, mask = cut_holes(complete, d)
    aug = data["augmentation"]
    complete, incomplete = augment(complete, d, aug), augment(incomplete, d,
                                                              aug)
    return unit_sphere(complete), unit_sphere(incomplete, mask), mask


def lr_factor(count: int, spe: int, opt: dict) -> float:
    """The schedule's factor for the update after ``count`` updates."""
    if opt["lr_schedule"] == "cosine":
        decay = max(opt["epochs"] * spe, 1)
        return 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))
    return opt["scheduler_gamma"] ** ((count // spe) // opt["scheduler_step"])


def train_steps(params: dict, state: dict, batches: List[Tensor],
                g: torch.Generator, cfg: dict, steps_per_epoch: int) -> dict:
    """Run one training step per batch of complete clouds from ``params``
    and ``state`` (copied, not changed). Returns the losses, each leaf's
    first gradient as the loss gives it (Adam adds the weight decay), and
    the parameters and BatchNorm state after the last step, by leaf
    path."""
    opt, data = cfg["training"]["autoencoder"], cfg["data"]
    b1, b2 = opt["betas"]
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in nets.leaves(params)}
    tree = _rebuild(params, p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for t, batch in enumerate(batches, start=1):
        d = draw_step(g, batch.shape[0], batch.shape[1],
                      data["hole_min_ratio"], data["hole_max_ratio"])
        complete, incomplete, mask = prepare(batch, d, data)
        stats = cfg["training"]["bn_stats"]
        gfv, enc_s = nets.encoder(tree["encoder"], state["encoder"],
                                  incomplete, mask, stats)
        recon, dec_s = nets.decoder(tree["decoder"], state["decoder"], gfv,
                                    stats)
        state = {"encoder": enc_s, "decoder": dec_s}
        loss = chamfer.chamfer(recon, complete).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(loss.detach())
        lr = opt["lr"] * lr_factor(t - 1, steps_per_epoch, opt)
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
        del grads, gd, gfv, recon, loss
    return {"losses": torch.stack(losses), "first_grad": first_grad,
            "params": {k: x.detach() for k, x in p.items()},
            "state": dict(nets.leaves(state))}


def _rebuild(tree, flat: Dict[str, Tensor], path=()):
    """``tree`` with each tensor replaced by ``flat``'s entry at its path."""
    if isinstance(tree, Tensor):
        return flat[".".join(map(str, path))]
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in tree.items()}
    return [_rebuild(v, flat, path + (i,)) for i, v in enumerate(tree)]
