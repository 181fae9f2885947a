"""The reference implementation's ``.pth`` checkpoints and the port's trees
(gan_rl_3d_tpu/utils/torch_convert.py).

The reference (a torch implementation of RL-GAN-Net) saves state dicts of
``nn.Sequential`` stacks: a Linear weight is (out, in), a 1x1 Conv1d
weight (out, in, 1), a spectral-normed Linear carries ``weight_orig`` with
its ``weight_u`` / ``weight_v`` vectors. The port's trees hold dense
weights as (in, out), as the JAX package's do. The ``convert_*`` functions
map a state dict to a (params, state) pair of CPU tensors, the
``export_*`` functions map back, with the reference's key names
(torch_convert.py:55-197, 199-367):

* ``export_reference_checkpoint`` writes the pair the reference's
  ``RLGANNet.load_checkpoint`` reads: ``path`` (autoencoder and latent-GAN
  state dicts) and ``*_rl_agent.pth`` (the six agent networks and fresh
  Adam states; optimizer moments are not carried either way);
* ``load_reference_checkpoint`` reads such a pair into a bundle
  ``{"ae", "lgan", "meta"[, "agent_networks"]}``.

The reference layout has the PointNet encoder and the MLP decoder only:
exporting the attention encoder or the adaptive decoder raises
ValueError, as the JAX package covers them in neither direction.
``convert_attention_encoder`` / ``convert_adaptive_decoder`` map the
reference's PointNetWithAttention / AdaptivePointDecoder state dicts.
Every tensor is copied, so a tree never aliases a state dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor
AGENT_NETWORKS = ("actor", "critic1", "critic2", "actor_target",
                  "critic1_target", "critic2_target")


def _t(x: Tensor) -> Tensor:
    return x.detach().to("cpu").clone()


def _dense_from(sd: Dict, key: str, weight_name: str = "weight") -> dict:
    w = _t(sd[f"{key}.{weight_name}"])
    if w.ndim == 3:  # Conv1d 1x1
        w = w[:, :, 0]
    return {"w": w.T.contiguous(), "b": _t(sd[f"{key}.bias"])}


def _bn_from(sd: Dict, key: str) -> Tuple[dict, dict]:
    return ({"scale": _t(sd[f"{key}.weight"]), "bias": _t(sd[f"{key}.bias"])},
            {"mean": _t(sd[f"{key}.running_mean"]),
             "var": _t(sd[f"{key}.running_var"])})


def _seq_indices(sd: Dict, prefix: str) -> List[int]:
    depth = len(prefix.split("."))
    return sorted({int(k.split(".")[depth]) for k in sd
                   if k.startswith(prefix + ".")})


def convert_bn_mlp(sd: Dict, prefix: str) -> Tuple[list, list]:
    """A torch Sequential of [Linear/Conv1d, BatchNorm?, activation, ...]
    -> a ``models.common.bn_mlp`` (params, state) pair."""
    params: list = []
    state: list = []
    for i in _seq_indices(sd, prefix):
        key = f"{prefix}.{i}"
        if f"{key}.running_mean" in sd:  # BatchNorm of the previous Dense
            params[-1]["bn"], state[-1]["bn"] = _bn_from(sd, key)
        elif f"{key}.weight" in sd:  # Linear / Conv1d
            params.append({"dense": _dense_from(sd, key)})
            state.append({})
    return params, state


def convert_autoencoder(sd: Dict) -> Tuple[dict, dict]:
    """PointCloudAutoencoder.state_dict() -> the PointNet autoencoder."""
    enc_p, enc_s = convert_bn_mlp(sd, "encoder.point_mlp")
    head_p, head_s = convert_bn_mlp(sd, "encoder.global_mlp")
    dec_p, dec_s = convert_bn_mlp(sd, "decoder.mlp")
    return ({"encoder": {"point_mlp": enc_p, "head": head_p},
             "decoder": {"mlp": dec_p}},
            {"encoder": {"point_mlp": enc_s, "head": head_s},
             "decoder": {"mlp": dec_s}})


def convert_latent_gan(sd: Dict) -> Tuple[dict, dict]:
    """LatentGAN.state_dict() -> the latent GAN: the spectral-norm
    discriminator (weight_orig, u, v) or the plain one, LayerNorms on the
    hidden layers."""
    gen_p, gen_s = convert_bn_mlp(sd, "generator.generator")
    disc_p: list = []
    disc_s: list = []
    prefix = "discriminator.discriminator"
    for i in _seq_indices(sd, prefix):
        key = f"{prefix}.{i}"
        if f"{key}.weight_orig" in sd:  # spectral-normed Linear
            disc_p.append({"dense": _dense_from(sd, key, "weight_orig")})
            disc_s.append({"sn": {"u": _t(sd[f"{key}.weight_u"]),
                                  "v": _t(sd[f"{key}.weight_v"])}})
        elif f"{key}.running_mean" in sd:
            raise ValueError("unexpected BatchNorm in discriminator")
        elif f"{key}.weight" in sd:
            if sd[f"{key}.weight"].ndim == 1:  # LayerNorm
                disc_p[-1]["ln"] = {"scale": _t(sd[f"{key}.weight"]),
                                    "bias": _t(sd[f"{key}.bias"])}
            else:  # plain Linear
                disc_p.append({"dense": _dense_from(sd, key)})
                disc_s.append({})
    return ({"generator": {"mlp": gen_p}, "discriminator": {"layers": disc_p}},
            {"generator": {"mlp": gen_s},
             "discriminator": {"layers": disc_s}})


def convert_attention_encoder(sd: Dict, prefix: str = ""
                              ) -> Tuple[dict, dict]:
    """PointNetWithAttention -> ``models.variants`` attention encoder."""
    mlp_p, mlp_s = convert_bn_mlp(sd, f"{prefix}point_mlp")
    head_p, head_s = convert_bn_mlp(sd, f"{prefix}global_mlp")
    att = {"fc1": _dense_from(sd, f"{prefix}attention.0"),
           "fc2": _dense_from(sd, f"{prefix}attention.2")}
    return ({"point_mlp": mlp_p, "attention": att, "head": head_p},
            {"point_mlp": mlp_s, "head": head_s})


def convert_adaptive_decoder(sd: Dict, prefix: str = ""
                             ) -> Tuple[dict, dict]:
    """AdaptivePointDecoder -> ``models.variants`` adaptive decoder."""
    feat_p, feat_s = convert_bn_mlp(sd, f"{prefix}feature_mlp")
    refine = {"conv1": _dense_from(sd, f"{prefix}refine_mlp.0"),
              "conv2": _dense_from(sd, f"{prefix}refine_mlp.3")}
    refine["bn"], bn_s = _bn_from(sd, f"{prefix}refine_mlp.1")
    return ({"feature_mlp": feat_p,
             "gen": _dense_from(sd, f"{prefix}point_mlp.0"),
             "refine": refine},
            {"feature_mlp": feat_s, "refine_bn": bn_s})


def convert_actor(sd: Dict) -> Tuple[dict, dict]:
    p, s = convert_bn_mlp(sd, "actor")
    return {"mlp": p}, {"mlp": s}


def convert_critic(sd: Dict) -> Tuple[dict, dict]:
    params = {ours: _dense_from(sd, theirs) for ours, theirs in (
        ("state_fc", "state_fc1"), ("action_fc", "action_fc"),
        ("comb_fc1", "combined_fc1"), ("comb_fc2", "combined_fc2"),
        ("out_fc", "output_fc"))}
    state = {}
    for ours, theirs in (("bn1", "state_bn1"), ("bn2", "combined_bn1"),
                         ("bn3", "combined_bn2")):
        params[ours], state[ours] = _bn_from(sd, theirs)
    return params, state


def convert_agent_networks(ckpt: Dict) -> Dict[str, dict]:
    """The six network state dicts of an agent checkpoint, each as
    {"params", "state"} (optimizer moments are not carried)."""
    out = {}
    for name in AGENT_NETWORKS:
        conv = convert_actor if "actor" in name else convert_critic
        p, s = conv(ckpt[name])
        out[name] = {"params": p, "state": s}
    return out


# ---------------------------------------------------------------------------
# Export: the port's trees -> reference state dicts (the inverse of the
# converters; a BN layer takes 3 Sequential slots, Dense + BN + activation)
# ---------------------------------------------------------------------------


def _emit_dense(sd: Dict, key: str, p: dict, *, conv: bool = False,
                weight_name: str = "weight") -> None:
    w = _t(p["w"]).T.contiguous()  # (in, out) -> torch (out, in)
    sd[f"{key}.{weight_name}"] = w[:, :, None] if conv else w
    sd[f"{key}.bias"] = _t(p["b"])


def _emit_bn(sd: Dict, key: str, bn_p: dict, bn_s: dict) -> None:
    sd[f"{key}.weight"] = _t(bn_p["scale"])
    sd[f"{key}.bias"] = _t(bn_p["bias"])
    sd[f"{key}.running_mean"] = _t(bn_s["mean"])
    sd[f"{key}.running_var"] = _t(bn_s["var"])
    # load_state_dict is strict about buffer keys
    sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def export_bn_mlp(params: list, state: list, prefix: str, *,
                  conv: bool = False) -> Dict:
    """The inverse of convert_bn_mlp: a layer with a BN takes 3 slots
    (Dense, BN, activation), one without takes 1."""
    sd: Dict = {}
    pos = 0
    for p, s in zip(params, state):
        _emit_dense(sd, f"{prefix}.{pos}", p["dense"], conv=conv)
        if "bn" in p:
            _emit_bn(sd, f"{prefix}.{pos + 1}", p["bn"], s["bn"])
            pos += 3
        else:
            pos += 1
    return sd


def check_reference_layout(ae_params: dict) -> None:
    """Raise ValueError unless the autoencoder is the PointNet encoder and
    the MLP decoder, the only pair the reference's .pth layout holds."""
    if "attention" in ae_params["encoder"] or "mlp" not in ae_params[
            "decoder"]:
        raise ValueError(
            "the reference .pth layout holds the PointNet encoder and the "
            "MLP decoder only; the attention encoder / adaptive decoder "
            "have no export (as in gan_rl_3d_tpu/utils/torch_convert.py): "
            "keep such a model in the package's own checkpoints")


def export_autoencoder(ae: Dict) -> Dict:
    """The PointNet autoencoder -> PointCloudAutoencoder.state_dict()."""
    p, s = ae["params"], ae["state"]
    check_reference_layout(p)
    sd = export_bn_mlp(p["encoder"]["point_mlp"], s["encoder"]["point_mlp"],
                       "encoder.point_mlp", conv=True)
    sd.update(export_bn_mlp(p["encoder"]["head"], s["encoder"]["head"],
                            "encoder.global_mlp"))
    sd.update(export_bn_mlp(p["decoder"]["mlp"], s["decoder"]["mlp"],
                            "decoder.mlp"))
    return sd


def export_latent_gan(lgan: Dict) -> Dict:
    """The latent GAN -> LatentGAN.state_dict(): a hidden discriminator
    layer takes 4 slots (Linear, LayerNorm, LeakyReLU, Dropout), the last
    one 1."""
    p, s = lgan["params"], lgan["state"]
    sd = export_bn_mlp(p["generator"]["mlp"], s["generator"]["mlp"],
                       "generator.generator")
    prefix = "discriminator.discriminator"
    pos = 0
    for lp, ls in zip(p["discriminator"]["layers"],
                      s["discriminator"]["layers"]):
        key = f"{prefix}.{pos}"
        if "sn" in ls:
            _emit_dense(sd, key, lp["dense"], weight_name="weight_orig")
            sd[f"{key}.weight_u"] = _t(ls["sn"]["u"])
            sd[f"{key}.weight_v"] = _t(ls["sn"]["v"])
        else:
            _emit_dense(sd, key, lp["dense"])
        if "ln" in lp:
            sd[f"{prefix}.{pos + 1}.weight"] = _t(lp["ln"]["scale"])
            sd[f"{prefix}.{pos + 1}.bias"] = _t(lp["ln"]["bias"])
            pos += 4
        else:
            pos += 1
    return sd


def export_actor(net: Dict) -> Dict:
    return export_bn_mlp(net["params"]["mlp"], net["state"]["mlp"], "actor")


def export_critic(net: Dict) -> Dict:
    p, s = net["params"], net["state"]
    sd: Dict = {}
    for ours, theirs in (("state_fc", "state_fc1"), ("action_fc", "action_fc"),
                         ("comb_fc1", "combined_fc1"),
                         ("comb_fc2", "combined_fc2"),
                         ("out_fc", "output_fc")):
        _emit_dense(sd, theirs, p[ours])
    for ours, theirs in (("bn1", "state_bn1"), ("bn2", "combined_bn1"),
                         ("bn3", "combined_bn2")):
        _emit_bn(sd, theirs, p[ours], s[ours])
    return sd


def _fresh_adam_state(sd: Dict, lr: float) -> Dict:
    """A fresh torch Adam state dict sized to ``sd``'s parameters (weights
    and biases; running statistics and num_batches_tracked are buffers)."""
    n = sum(1 for k in sd if k.endswith((".weight", ".bias", ".weight_orig")))
    params = [torch.nn.Parameter(torch.zeros(1)) for _ in range(n)]
    return torch.optim.Adam(params, lr=lr).state_dict()


def export_reference_checkpoint(model: Dict, path: str, *, epoch: int = 0,
                                phase: str = "joint",
                                config: Optional[Dict] = None,
                                actor_lr: float = 1e-4,
                                critic_lr: float = 1e-3) -> str:
    """Write the model as the reference's .pth pair: ``path`` with the
    autoencoder and latent-GAN state dicts, and the ``*_rl_agent.pth``
    sibling with the six agent networks and fresh Adam states. ``model``
    holds ``ae``, ``lgan`` and the whole agent (``agent[name]`` each
    {"params", "state"}) on any device. Returns the sibling's path."""
    check_reference_layout(model["ae"]["params"])
    torch.save({"epoch": epoch, "phase": phase, "config": config or {},
                "autoencoder_state_dict": export_autoencoder(model["ae"]),
                "latent_gan_state_dict": export_latent_gan(model["lgan"])},
               path)
    agent = model["agent"]
    rl_sd = {name: (export_actor if "actor" in name else export_critic)(
        agent[name]) for name in AGENT_NETWORKS}
    rl_sd["actor_optimizer"] = _fresh_adam_state(rl_sd["actor"], actor_lr)
    for c in ("critic1", "critic2"):
        rl_sd[f"{c}_optimizer"] = _fresh_adam_state(rl_sd[c], critic_lr)
    rl_path = str(path).replace(".pth", "_rl_agent.pth")
    torch.save(rl_sd, rl_path)
    return rl_path


def load_reference_checkpoint(path: str) -> Dict:
    """A reference .pth (and its ``*_rl_agent.pth`` sibling, when there is
    one) -> {"ae", "lgan" each {"params", "state"}, "meta": {"epoch",
    "phase"}[, "agent_networks"]}, CPU tensors. The files are trusted
    pickles, as torch.save writes them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    ae_p, ae_s = convert_autoencoder(ckpt["autoencoder_state_dict"])
    lg_p, lg_s = convert_latent_gan(ckpt["latent_gan_state_dict"])
    bundle = {"ae": {"params": ae_p, "state": ae_s},
              "lgan": {"params": lg_p, "state": lg_s},
              "meta": {"epoch": ckpt.get("epoch"), "phase": ckpt.get("phase")}}
    rl_path = str(path).replace(".pth", "_rl_agent.pth")
    try:
        rl_ckpt = torch.load(rl_path, map_location="cpu", weights_only=False)
    except FileNotFoundError:
        return bundle
    bundle["agent_networks"] = convert_agent_networks(rl_ckpt)
    return bundle
