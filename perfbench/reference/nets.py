"""The networks, written out plainly: dense layers, BatchNorm in eval and
training mode, LayerNorm, spectral norm, and the encoders, decoders, actor,
generator and discriminator built from them."""

from typing import List, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
# a training statistics mode ("centered", "single_read_grouped"), or False
# for eval mode with the running statistics
Mode = Union[str, bool]
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LN_EPS = 1e-5
LEAK = 0.2


def dense(p: dict, x: Tensor) -> Tensor:
    return x @ p["w"] + p["b"]


def bn_eval(p: dict, s: dict, x: Tensor) -> Tensor:
    return (x - s["mean"]) / torch.sqrt(s["var"] + BN_EPS) * p["scale"] \
        + p["bias"]


BN_GROUPS = 8


def _compensated_sum(parts: Tensor) -> Tensor:
    """The rows of ``parts`` summed in order with Neumaier's compensation."""
    total, comp = parts[0], torch.zeros_like(parts[0])
    for part in parts[1:]:
        t = total + part
        comp = comp + torch.where(total.abs() >= part.abs(),
                                  (total - t) + part, (part - t) + total)
        total = t
    return total + comp


def batch_moments(x: Tensor, stats: str) -> Tuple[Tensor, Tensor]:
    """(mean, biased variance) over every axis but the last, as the
    configuration's ``training.bn_stats`` states them: "centered", two
    passes; "single_read_grouped", one read of the rows for the sum and
    the sum of squares, in 8 equal groups of the leading axis combined in
    order with Neumaier's compensation, variance = E[x^2] - E[x]^2 (at
    least 0); a leading axis that 8 does not divide is taken centered."""
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    if stats == "single_read_grouped" and x.shape[0] % BN_GROUPS == 0:
        groups = rows.reshape(BN_GROUPS, -1, rows.shape[-1])
        mean = _compensated_sum(groups.sum(dim=1)) / n
        square = _compensated_sum((groups * groups).sum(dim=1)) / n
        return mean, torch.clamp(square - mean * mean, min=0.0)
    if stats not in ("centered", "single_read_grouped"):
        raise ValueError(f"unknown BatchNorm statistics {stats!r}")
    mean = rows.mean(dim=0)
    return mean, (rows - mean).square().mean(dim=0)


def bn_train(p: dict, s: dict, x: Tensor, stats: str
             ) -> Tuple[Tensor, dict]:
    """Batch statistics by ``stats``, normalised with the biased variance;
    the running variance takes the unbiased one."""
    n = x.numel() // x.shape[-1]
    mean, var = batch_moments(x, stats)
    y = (x - mean) / torch.sqrt(var + BN_EPS) * p["scale"] + p["bias"]
    with torch.no_grad():
        new = {"mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean,
               "var": (1 - BN_MOMENTUM) * s["var"]
               + BN_MOMENTUM * var * (n / (n - 1))}
    return y, new


def bn_mlp(ps: list, ss: list, x: Tensor, train: Mode,
           final=None) -> Tuple[Tensor, list]:
    """Dense -> BatchNorm -> ReLU blocks; a block without BatchNorm is a
    plain dense layer followed by ``final`` where given."""
    new_states = []
    for p, s in zip(ps, ss):
        x = dense(p["dense"], x)
        if "bn" in p:
            if train:
                x, bn_s = bn_train(p["bn"], s["bn"], x, train)
            else:
                x, bn_s = bn_eval(p["bn"], s["bn"], x), s["bn"]
            new_states.append({"bn": bn_s})
            x = torch.relu(x)
        else:
            new_states.append({})
            if final is not None:
                x = final(x)
    return x, new_states


def pointnet_encoder(p: dict, s: dict, pc: Tensor, mask: Optional[Tensor],
                     train: Mode) -> Tuple[Tensor, dict]:
    """Shared point MLP, max over the points the mask keeps, then the head."""
    feats, mlp_s = bn_mlp(p["point_mlp"], s["point_mlp"], pc, train)
    if mask is not None:
        feats = feats.masked_fill(mask[..., None] <= 0, float("-inf"))
    gfv, head_s = bn_mlp(p["head"], s["head"], feats.amax(dim=1), train)
    return gfv, {"point_mlp": mlp_s, "head": head_s}


def attention_encoder(p: dict, s: dict, pc: Tensor, mask: Optional[Tensor],
                      train: Mode) -> Tuple[Tensor, dict]:
    """Shared point MLP, then sigmoid attention weights (c -> c/4 -> 1), zero
    on padded points, and the weighted mean of the point features."""
    feats, mlp_s = bn_mlp(p["point_mlp"], s["point_mlp"], pc, train)
    att = p["attention"]
    a = torch.sigmoid(dense(att["fc2"], torch.relu(dense(att["fc1"],
                                                         feats))))
    if mask is not None:
        a = a * mask[..., None]
    pooled = (feats * a).sum(dim=1) / (a.sum(dim=1) + 1e-8)
    gfv, head_s = bn_mlp(p["head"], s["head"], pooled, train)
    return gfv, {"point_mlp": mlp_s, "head": head_s}


def mlp_decoder(p: dict, s: dict, gfv: Tensor, train: Mode
                ) -> Tuple[Tensor, dict]:
    x, mlp_s = bn_mlp(p["mlp"], s["mlp"], gfv, train)
    return x.reshape(x.shape[0], -1, 3), {"mlp": mlp_s}


def adaptive_decoder(p: dict, s: dict, gfv: Tensor, train: Mode
                     ) -> Tuple[Tensor, dict]:
    """Feature MLP, a tanh point generator, then a pointwise residual
    refinement 3 -> 64 (BatchNorm over every point of the batch) -> 3."""
    feats, feat_s = bn_mlp(p["feature_mlp"], s["feature_mlp"], gfv, train)
    pts = torch.tanh(dense(p["gen"], feats))
    pts = pts.reshape(pts.shape[0], -1, 3)
    ref = p["refine"]
    r = dense(ref["conv1"], pts)
    if train:
        r, bn_s = bn_train(ref["bn"], s["refine_bn"], r, train)
    else:
        r, bn_s = bn_eval(ref["bn"], s["refine_bn"], r), s["refine_bn"]
    r = dense(ref["conv2"], torch.relu(r))
    return pts + r, {"feature_mlp": feat_s, "refine_bn": bn_s}


def encoder(p: dict, s: dict, pc: Tensor, mask: Optional[Tensor],
            train: Mode) -> Tuple[Tensor, dict]:
    fn = attention_encoder if "attention" in p else pointnet_encoder
    return fn(p, s, pc, mask, train)


def decoder(p: dict, s: dict, gfv: Tensor, train: Mode
            ) -> Tuple[Tensor, dict]:
    fn = adaptive_decoder if "feature_mlp" in p else mlp_decoder
    return fn(p, s, gfv, train)


def actor(p: dict, s: dict, state: Tensor, action_bound: float) -> Tensor:
    return bn_mlp(p["mlp"], s["mlp"], state, False, torch.tanh)[0] \
        * action_bound


def generator(p: dict, s: dict, z: Tensor) -> Tensor:
    return bn_mlp(p["mlp"], s["mlp"], z, False, torch.tanh)[0]


def layernorm(p: dict, x: Tensor) -> Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p["scale"] + p["bias"]


def discriminator(p: dict, s: dict, gfv: Tensor) -> Tensor:
    """Eval mode: each weight over its spectral norm estimate
    sigma = v . (W u), LayerNorm and LeakyReLU(0.2) on the hidden layers."""
    x = gfv
    for lp, ls in zip(p["layers"], s["layers"]):
        w = lp["dense"]["w"]
        if "sn" in ls:
            w = w / torch.dot(ls["sn"]["v"], w @ ls["sn"]["u"])
        x = x @ w + lp["dense"]["b"]
        if "ln" in lp:
            x = torch.nn.functional.leaky_relu(layernorm(lp["ln"], x), LEAK)
    return x


def leaves(tree, path: Tuple = ()) -> List[Tuple[str, Tensor]]:
    """(dotted path, tensor) of every tensor in a tree of dicts and lists,
    in a fixed order."""
    if isinstance(tree, Tensor):
        return [(".".join(map(str, path)), tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out += leaves(v, path + (k,))
    return out
