"""Port parity for the reference implementation's ``.pth`` bridge
(gan_rl_3d_tpu/utils/torch_convert.py -> gan_rl_3d_tpu_torch/utils/
torch_convert.py): a pair the JAX package exports loads in the port as it
loads in JAX, bit for bit; the port's export has JAX's keys and tensors and
JAX loads it back to the model; the converters of the attention encoder
and the adaptive decoder against JAX's on a state dict with the
reference's key names; the variants' export refused. CPU, small widths."""

import jax
import numpy as np
import pytest
import torch

from gan_rl_3d_tpu.utils import torch_convert as jtc
from gan_rl_3d_tpu_torch.convert import agent_from_numpy, model_from_numpy
from gan_rl_3d_tpu_torch.models import rl_gan_net as tnet
from gan_rl_3d_tpu_torch.utils import torch_convert as ttc
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_modules import (port_small_config, small_clouds,
                                     small_model_tree, t)
from test_torch_port_variants import variant_model_tree

AGENT = ttc.AGENT_NETWORKS


def _full_jax_tree(seed, spectral_norm=True):
    """A JAX model tree with the whole agent; without spectral norm the
    discriminator is the plain LayerNorm variant."""
    config, tree = small_model_tree(seed=seed)
    if not spectral_norm:
        for layer in tree["lgan"]["state"]["discriminator"]["layers"]:
            layer.pop("sn")
    return config, tree


def _port_model(tree):
    """The port's model of a JAX tree: ae, lgan and the whole agent."""
    return {**model_from_numpy(tree, device="cpu"),
            "agent": agent_from_numpy(tree["agent"],
                                      port_small_config().td3_config(),
                                      device="cpu")}


def _assert_bits(port_tree, jax_tree):
    port_l, ref_l = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(port_l) == len(ref_l)
    for a, b in zip(port_l, ref_l):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("spectral_norm", [True, False])
def test_port_loads_a_jax_exported_pair_as_jax_does(tmp_path,
                                                    spectral_norm):
    """JAX's export_reference_checkpoint writes model.pth and
    model_rl_agent.pth; the port's loader gives JAX's loader's tree bit for
    bit (which is the model exported), and the meta."""
    _, tree = _full_jax_tree(31, spectral_norm)
    path = str(tmp_path / "model.pth")
    rl_path = jtc.export_reference_checkpoint(tree, path, epoch=5,
                                              phase="rl_agent")
    assert rl_path == str(tmp_path / "model_rl_agent.pth")
    ref = jtc.load_reference_checkpoint(path)
    out = ttc.load_reference_checkpoint(path)
    assert out["meta"] == ref["meta"] == {"epoch": 5, "phase": "rl_agent"}
    for k in ("ae", "lgan", "agent_networks"):
        _assert_bits(out[k], ref[k])
    _assert_bits(out["ae"], tree["ae"])
    _assert_bits(out["agent_networks"]["critic2"], tree["agent"]["critic2"])


def test_port_export_has_jax_keys_and_tensors_and_jax_loads_it(tmp_path):
    """The port's export of a model equals JAX's export of the same
    weights key for key and tensor for tensor (Adam states included), and
    JAX's loader reads the port's pair back to the model; the port's
    loader reads it back too, and ``complete`` on it equals ``complete``
    on the model bit for bit."""
    config, tree = _full_jax_tree(32)
    model = _port_model(tree)
    port_path, jax_path = str(tmp_path / "p.pth"), str(tmp_path / "j.pth")
    ttc.export_reference_checkpoint(model, port_path, epoch=3)
    jtc.export_reference_checkpoint(tree, jax_path, epoch=3)
    for suffix in ("", "_rl_agent"):
        mine = torch.load(port_path.replace(".pth", suffix + ".pth"),
                          weights_only=False)
        ref = torch.load(jax_path.replace(".pth", suffix + ".pth"),
                         weights_only=False)
        assert mine.keys() == ref.keys()
        for k in mine:
            if isinstance(ref[k], dict) and k.endswith("state_dict") or (
                    suffix and k in AGENT):
                assert mine[k].keys() == ref[k].keys(), k
                for name in ref[k]:
                    a, b = mine[k][name], ref[k][name]
                    assert a.dtype == b.dtype and torch.equal(a, b), name
            else:
                assert mine[k] == ref[k], k
    back = jtc.load_reference_checkpoint(port_path)
    for k in ("ae", "lgan"):
        _assert_bits(tree_map(t, jax.tree.map(np.asarray, back[k])), tree[k])
    for name in AGENT:
        _assert_bits(tree_map(t, jax.tree.map(np.asarray,
                                              back["agent_networks"][name])),
                     tree["agent"][name])
    mine = ttc.load_reference_checkpoint(port_path)
    served = {"ae": mine["ae"], "lgan": mine["lgan"],
              "agent": {"actor": mine["agent_networks"]["actor"]}}
    pc, mask = small_clouds(seed=33)
    cfg = port_small_config().td3_config()
    ref_out = tnet.complete(model, t(pc), t(mask), cfg=cfg)
    out = tnet.complete(served, t(pc), t(mask), cfg=cfg)
    for k in ref_out:
        assert torch.equal(out[k], ref_out[k]), k


def test_loader_without_the_agent_sibling(tmp_path):
    """A combined .pth alone (no *_rl_agent.pth) loads without
    ``agent_networks``, as in JAX."""
    _, tree = _full_jax_tree(34)
    path = str(tmp_path / "solo.pth")
    ttc.export_reference_checkpoint(_port_model(tree), path)
    (tmp_path / "solo_rl_agent.pth").unlink()
    out = ttc.load_reference_checkpoint(path)
    assert set(out) == set(jtc.load_reference_checkpoint(path)) == {
        "ae", "lgan", "meta"}


def _reference_variant_state_dict(tree):
    """The reference's PointNetWithAttention / AdaptivePointDecoder state
    dicts (reference models/autoencoder.py:174-323: point_mlp as 1x1
    Conv1d, attention Sequential(Linear, ReLU, Linear, Sigmoid),
    global_mlp; feature_mlp, point_mlp Sequential(Linear, Tanh),
    refine_mlp Sequential(Conv1d, BN, ReLU, Conv1d)), written with the
    JAX exporter's helpers from a variant tree."""
    p, s = tree["ae"]["params"], tree["ae"]["state"]
    enc = jtc.export_bn_mlp(p["encoder"]["point_mlp"],
                            s["encoder"]["point_mlp"], "point_mlp", conv=True)
    enc.update(jtc.export_bn_mlp(p["encoder"]["head"], s["encoder"]["head"],
                                 "global_mlp"))
    jtc._emit_dense(enc, "attention.0", p["encoder"]["attention"]["fc1"])
    jtc._emit_dense(enc, "attention.2", p["encoder"]["attention"]["fc2"])
    dec = jtc.export_bn_mlp(p["decoder"]["feature_mlp"],
                            s["decoder"]["feature_mlp"], "feature_mlp")
    jtc._emit_dense(dec, "point_mlp.0", p["decoder"]["gen"])
    refine = p["decoder"]["refine"]
    jtc._emit_dense(dec, "refine_mlp.0", refine["conv1"], conv=True)
    jtc._emit_bn(dec, "refine_mlp.1", refine["bn"], s["decoder"]["refine_bn"])
    jtc._emit_dense(dec, "refine_mlp.3", refine["conv2"], conv=True)
    return enc, dec


@pytest.mark.parametrize("prefix", ["", "autoencoder.encoder."])
def test_variant_converters_match_jax(prefix):
    """convert_attention_encoder / convert_adaptive_decoder on the
    reference's key names (with and without a module prefix): the port's
    trees equal JAX's bit for bit, and both are the variant tree the state
    dicts were written from."""
    _, tree = variant_model_tree(seed=35)
    enc, dec = _reference_variant_state_dict(tree)
    enc = {prefix + k: v for k, v in enc.items()}
    dec = {prefix + k: v for k, v in dec.items()}
    for conv, sd, half in (("attention_encoder", enc, "encoder"),
                           ("adaptive_decoder", dec, "decoder")):
        ref = getattr(jtc, f"convert_{conv}")(sd, prefix)
        out = getattr(ttc, f"convert_{conv}")(sd, prefix)
        _assert_bits(out, ref)
        _assert_bits(out[0], tree["ae"]["params"][half])
        _assert_bits(out[1], tree["ae"]["state"][half])


def test_exporting_a_variant_model_refuses(tmp_path):
    """The reference .pth layout has no attention encoder or adaptive
    decoder (neither has JAX's exporter): a clear ValueError, no file."""
    _, tree = variant_model_tree(seed=36)
    model = _port_model(tree)
    path = tmp_path / "v.pth"
    with pytest.raises(ValueError, match="PointNet encoder and the MLP"):
        ttc.export_reference_checkpoint(model, str(path))
    with pytest.raises(ValueError, match="PointNet encoder and the MLP"):
        ttc.export_autoencoder(model["ae"])
    assert not path.exists()
