"""Seeded weights in the JAX package's tree layout, made on the device.

Every leaf of a model is cut from one ``torch.rand`` call on a device
generator: a dense layer's weight and bias uniform in +-1/sqrt(fan_in)
(torch's default), BatchNorm and LayerNorm parameters and BatchNorm's
running statistics either at their initial values (``fresh``, for
training) or drawn around them (for serving, so that folding the
statistics into the layers does real work). Spectral-norm vectors are the
top singular vectors of their weight, by power iteration.

The trees are the benchmark's inputs: the harness hands the program a copy
in the program's layout and the reference reads the same values.
"""

from typing import List, Optional, Sequence, Tuple

import torch

# (path, shape, low, high); a shape of None stands for an empty dict, the
# state of a layer without BatchNorm
Spec = List[Tuple[tuple, Optional[tuple], float, float]]


def _dense(spec: Spec, path: tuple, d_in: int, d_out: int) -> None:
    bound = 1.0 / d_in ** 0.5
    spec.append((path + ("w",), (d_in, d_out), -bound, bound))
    spec.append((path + ("b",), (d_out,), -bound, bound))


def _norm(spec: Spec, path: tuple, dim: int, fresh: bool) -> None:
    spec.append((path + ("scale",), (dim,)) + ((1.0, 1.0) if fresh
                                               else (0.8, 1.2)))
    spec.append((path + ("bias",), (dim,)) + ((0.0, 0.0) if fresh
                                              else (-0.1, 0.1)))


def _bn_state(spec: Spec, path: tuple, dim: int, fresh: bool) -> None:
    spec.append((path + ("mean",), (dim,)) + ((0.0, 0.0) if fresh
                                              else (-0.1, 0.1)))
    spec.append((path + ("var",), (dim,)) + ((1.0, 1.0) if fresh
                                             else (0.5, 1.5)))


def _bn_mlp(spec: Spec, p: tuple, s: tuple, d_in: int, dims: Sequence[int],
            fresh: bool, final_plain: bool = False) -> None:
    for i, d_out in enumerate(dims):
        _dense(spec, p + (i, "dense"), d_in, d_out)
        if final_plain and i == len(dims) - 1:
            spec.append((s + (i,), None, 0.0, 0.0))
        else:
            _norm(spec, p + (i, "bn"), d_out, fresh)
            _bn_state(spec, s + (i, "bn"), d_out, fresh)
        d_in = d_out


def ae_spec(ae: dict, fresh: bool) -> Spec:
    """Leaves of the autoencoder under ("ae", "params"|"state", ...)."""
    spec: Spec = []
    p, s = ("ae", "params"), ("ae", "state")
    dims = ae["encoder_dims"]
    _bn_mlp(spec, p + ("encoder", "point_mlp"), s + ("encoder", "point_mlp"),
            ae["input_dim"], dims, fresh)
    if ae["encoder_type"] == "attention":
        c = dims[-1]
        _dense(spec, p + ("encoder", "attention", "fc1"), c, c // 4)
        _dense(spec, p + ("encoder", "attention", "fc2"), c // 4, 1)
    _bn_mlp(spec, p + ("encoder", "head"), s + ("encoder", "head"), dims[-1],
            [ae["latent_dim"]], fresh)
    if ae["decoder_type"] == "adaptive":
        feat = ae["adaptive_dims"]
        _bn_mlp(spec, p + ("decoder", "feature_mlp"),
                s + ("decoder", "feature_mlp"), ae["latent_dim"], feat, fresh)
        _dense(spec, p + ("decoder", "gen"), feat[-1], ae["num_points"] * 3)
        hidden = ae["refine_dim"]
        _dense(spec, p + ("decoder", "refine", "conv1"), 3, hidden)
        _dense(spec, p + ("decoder", "refine", "conv2"), hidden, 3)
        _norm(spec, p + ("decoder", "refine", "bn"), hidden, fresh)
        _bn_state(spec, s + ("decoder", "refine_bn"), hidden, fresh)
    else:
        _bn_mlp(spec, p + ("decoder", "mlp"), s + ("decoder", "mlp"),
                ae["latent_dim"], ae["decoder_dims"], fresh, final_plain=True)
    return spec


def serving_spec(model: dict) -> Spec:
    """Leaves of the whole served model: the autoencoder, the latent GAN
    (generator and discriminator) and the TD3 actor, with drawn
    normalisation statistics."""
    spec = ae_spec(model["autoencoder"], fresh=False)
    lg = model["lgan"]
    if not lg["spectral_norm"]:
        raise ValueError("the served discriminator is modelled with "
                         "spectral norm only")
    _bn_mlp(spec, ("lgan", "params", "generator", "mlp"),
            ("lgan", "state", "generator", "mlp"), lg["z_dim"],
            lg["generator_dims"], False, final_plain=True)
    d_in = lg["latent_dim"]
    dims = lg["discriminator_dims"]
    for i, d_out in enumerate(dims):
        p = ("lgan", "params", "discriminator", "layers", i)
        _dense(spec, p + ("dense",), d_in, d_out)
        if i < len(dims) - 1:
            _norm(spec, p + ("ln",), d_out, False)
        s = ("lgan", "state", "discriminator", "layers", i, "sn")
        spec.append((s + ("u",), (d_out,), -1.0, 1.0))
        spec.append((s + ("v",), (d_in,), -1.0, 1.0))
        d_in = d_out
    rl = model["rl_agent"]
    _bn_mlp(spec, ("actor", "params", "mlp"), ("actor", "state", "mlp"),
            rl["state_dim"], list(rl["hidden_dims"]) + [rl["action_dim"]],
            False, final_plain=True)
    return spec


def build(spec: Spec, g: torch.Generator) -> dict:
    """The tree of ``spec``'s leaves, all cut from one uniform draw on
    ``g``'s device; list positions are the integer path parts."""
    total = sum(_numel(shape) for _, shape, _, _ in spec if shape)
    flat = torch.rand(total, generator=g, device=g.device)
    root: dict = {}
    off = 0
    for path, shape, lo, hi in spec:
        if shape is None:
            _put(root, path, {})
            continue
        n = _numel(shape)
        _put(root, path, (lo + (hi - lo) * flat[off:off + n]).view(shape))
        off += n
    _power_iterate(root)
    return _lists(root)


def generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _put(root: dict, path: tuple, value) -> None:
    node = root
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _lists(node):
    """Dicts keyed 0..n-1 become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


@torch.no_grad()
def _power_iterate(root: dict, iterations: int = 30) -> None:
    """Set each spectral-norm (u, v) pair to the top singular vectors of
    its weight, so that sigma = v . (W u) is the weight's spectral norm."""
    lgan = root.get("lgan")
    if lgan is None:
        return
    layers_p = lgan["params"]["discriminator"]["layers"]
    for i, layer_s in lgan["state"]["discriminator"]["layers"].items():
        w = layers_p[i]["dense"]["w"]
        u, v = layer_s["sn"]["u"], layer_s["sn"]["v"]
        for _ in range(iterations):
            v = w @ u
            v = v / v.norm()
            u = v @ w
            u = u / u.norm()
        layer_s["sn"]["u"], layer_s["sn"]["v"] = u.contiguous(), v.contiguous()
