"""Folded inference engine for the completion path
(gan_rl_3d_tpu/models/inference.py).

``prepare_inference_engine`` folds every eval-mode normalisation into plain
affine layers (BatchNorm into the preceding dense, the spectral-norm sigma
into the discriminator weights) and casts to the compute dtype.
With ``quantize_int8`` the encoder's point-MLP is also quantized to int8
(``ops.quantize.quantize_encoder``). ``complete_fast`` drives the engine:
the encoder through kernel K1, or K6 for an int8 engine, then the actor,
generator, decoder and discriminator as plain matmuls.

The engine is a dictionary in the JAX engine's layout, so a JAX-written
f32 engine file (int8 or not) loads as it is:
  encoder: {"layers": [(w, b)] * 5, "head": (w, b)}
  encoder_q (int8 engines): {"layer0": (w0, b0),
                             "layers_q": [(wq int8, s_w, b)] * 4}
  decoder, generator, actor[, gan_generator, gan_decoder]: [(w, b), ...]
  discriminator: [(w, b, ln_params or None), ...]
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.models.rl_gan_net import check_gate_mode, gate
from gan_rl_3d_tpu_torch.ops import encoder_kernel, quantize
from gan_rl_3d_tpu_torch.utils.checkpoint import NumpyUnpickler, to_numpy
from gan_rl_3d_tpu_torch.utils.tree import tree_map

Tensor = torch.Tensor

_ACTS = {"relu": torch.relu, "tanh": torch.tanh, "none": lambda x: x}


def _fold_bn_mlp(params: list, state: list) -> list:
    out = []
    for p, s in zip(params, state):
        if "bn" in p:
            out.append(encoder_kernel.fold_bn(p["dense"], p["bn"], s["bn"]))
        else:
            out.append((p["dense"]["w"], p["dense"]["b"]))
    return out


def _fold_discriminator(params: dict, state: dict) -> list:
    """Spectral norm folds (sigma from the stored u, v); LayerNorm stays a
    runtime op. Entries: (w, b, ln_params or None)."""
    out = []
    for p, s in zip(params["layers"], state["layers"]):
        w = p["dense"]["w"]
        if "sn" in s:
            w = nn.spectral_norm_eval(w, s["sn"])
        out.append((w, p["dense"]["b"], p.get("ln")))
    return out


def cast_engine(engine: dict, dtype: torch.dtype) -> dict:
    """Cast as the JAX package does (inference.py:111-143): the encoder's
    point-MLP weights and biases, and every other 2-D weight, to ``dtype``;
    the remaining biases and the LayerNorm parameters stay f32. The int8
    bundle ``encoder_q`` is left as it is."""
    def cast(x):
        if isinstance(x, Tensor) and x.ndim == 2:
            return x.to(dtype)
        if isinstance(x, (list, tuple)):
            return type(x)(cast(v) for v in x)
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        return x

    out = cast({k: v for k, v in engine.items() if k != "encoder_q"})
    if "encoder_q" in engine:
        out["encoder_q"] = engine["encoder_q"]
    out["encoder"]["layers"] = [(w.to(dtype), b.to(dtype))
                                for w, b in out["encoder"]["layers"]]
    return out


def check_foldable(ae_params: dict) -> None:
    """Raise ValueError unless the autoencoder folds into an engine: the
    attention encoder's data-dependent pooling and the adaptive decoder's
    residual refinement do not (inference.py:99-108); ``complete`` serves
    them."""
    if "attention" in ae_params["encoder"]:
        raise ValueError(
            "inference engine folding supports the pointnet encoder; the "
            "attention variant's data-dependent pooling cannot fold - use "
            "models.rl_gan_net.complete")
    if "mlp" not in ae_params["decoder"]:
        raise ValueError(
            "inference engine folding supports the MLP decoder; the "
            "adaptive variant's residual refinement cannot fold - use "
            "models.rl_gan_net.complete")


@torch.no_grad()
def prepare_inference_engine(model: dict, *,
                             dtype: torch.dtype = torch.float32,
                             quantize_int8: bool = False) -> dict:
    """Fold the model into a deployment engine for ``complete_fast``
    (inference.py:84-150). With ``quantize_int8`` the engine also carries
    ``encoder_q``, the int8 bundle quantized from an f32 fold of the
    encoder, which ``complete_fast`` runs instead of ``encoder.layers``;
    the tail stays in ``dtype``."""
    ae_p, ae_s = model["ae"]["params"], model["ae"]["state"]
    check_foldable(ae_p)
    lg_p, lg_s = model["lgan"]["params"], model["lgan"]["state"]
    actor = model["agent"]["actor"]
    engine = {
        "encoder": encoder_kernel.fold_encoder_params(ae_p["encoder"],
                                                      ae_s["encoder"]),
        "decoder": _fold_bn_mlp(ae_p["decoder"]["mlp"], ae_s["decoder"]["mlp"]),
        "generator": _fold_bn_mlp(lg_p["generator"]["mlp"],
                                  lg_s["generator"]["mlp"]),
        "actor": _fold_bn_mlp(actor["params"]["mlp"], actor["state"]["mlp"]),
        "discriminator": _fold_discriminator(lg_p["discriminator"],
                                             lg_s["discriminator"]),
    }
    snap = model.get("gan_path")
    if snap is not None:
        engine["gan_generator"] = _fold_bn_mlp(
            snap["generator"]["params"]["mlp"], snap["generator"]["state"]["mlp"])
        engine["gan_decoder"] = _fold_bn_mlp(
            snap["decoder"]["params"]["mlp"], snap["decoder"]["state"]["mlp"])
    engine = cast_engine(engine, dtype)
    if quantize_int8:
        folded_f32 = encoder_kernel.fold_encoder_params(ae_p["encoder"],
                                                        ae_s["encoder"])
        engine["encoder_q"] = quantize.quantize_encoder(folded_f32["layers"])
    return engine


def save_engine(path: str, engine: dict) -> None:
    """Write the engine as a pickle of numpy arrays in the JAX engine's tree
    layout (what gan_rl_3d_tpu's save_engine writes for f32): floating
    leaves as f32, the int8 weights as int8."""
    with open(path, "wb") as f:
        pickle.dump(tree_map(to_numpy, engine), f)


class _EngineUnpickler(NumpyUnpickler):
    """Numpy arrays only. A bf16 engine written by the JAX package pickles
    its arrays with the dtype ``ml_dtypes.bfloat16``; a stand-in reads
    them as their raw 16-bit words (``<u2``), which ``engine_from_numpy``
    views as ``torch.bfloat16``, with no rounding anywhere. Any other
    ``ml_dtypes`` type is refused."""

    what = "engine"

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            if name == "bfloat16":
                return np.uint16
            raise ValueError(
                f"engine holds {module}.{name} arrays, which the port cannot "
                "read without ml_dtypes; export the engine in float32 and "
                "load it with dtype=torch.bfloat16 to serve in bf16")
        return super().find_class(module, name)


def load_engine(path: str, *, device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Read an engine file (this package's or the JAX package's, f32, bf16
    or int8) onto ``device``, cast to ``dtype``."""
    from gan_rl_3d_tpu_torch.convert import engine_from_numpy

    with open(path, "rb") as f:
        tree = _EngineUnpickler(f).load()
    return engine_from_numpy(tree, device=device, dtype=dtype)


def _apply_mlp(layers: list, x: Tensor, dtype: torch.dtype,
               final_act: str = "none") -> Tensor:
    """Dense stack: operands rounded to ``dtype``, products summed in f32,
    f32 bias; ReLU between layers (inference.py:63-70)."""
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        x = (torch.matmul(x.to(dtype).float(), w.to(dtype).float())
             + b.float())
        x = _ACTS["relu" if i < n - 1 else final_act](x)
    return x


def _apply_discriminator(layers: list, x: Tensor, dtype: torch.dtype,
                         leak: float = 0.2) -> Tensor:
    for w, b, ln in layers:
        x = (torch.matmul(x.to(dtype).float(), w.to(dtype).float())
             + b.float())
        if ln is not None:
            x = nn.leaky_relu(nn.layernorm(ln, x), leak)
    return x


@torch.no_grad()
def complete_fast(engine: dict, pc: Tensor, mask: Optional[Tensor] = None, *,
                  hybrid: bool = True,
                  gate_mode: str = "discriminator",
                  gate_bias: float = 0.0) -> Dict[str, Tensor]:
    """Folded completion with the outputs of models.rl_gan_net.complete
    (add_noise=False) (inference.py:166-255).

    The compute dtype is the engine's (f32 or bf16, see
    ``prepare_inference_engine`` and ``load_engine``). The encoder is K1 on
    a CUDA tensor in either dtype, or K6 and the f32 head for an engine
    with ``encoder_q`` (inference.py:196-201); the device of ``pc``
    decides, there is no switch."""
    check_gate_mode(gate_mode)
    dtype = engine["encoder"]["layers"][0][0].dtype
    bsz = pc.shape[0]
    if "encoder_q" in engine:
        noisy_gfv = encoder_kernel.apply_head(
            encoder_kernel.fused_encoder_pool_int8(pc, engine["encoder_q"],
                                                   mask),
            engine["encoder"]["head"])
    else:
        noisy_gfv = encoder_kernel.encode_fused(pc, engine["encoder"], mask,
                                                compute_dtype=dtype)
    z = _apply_mlp(engine["actor"], noisy_gfv, dtype, "tanh")
    if "gan_decoder" in engine:
        # the preserved serving GAN branch decodes through its own weights,
        # so the two branches take two (B, .) passes
        clean_gfv = _apply_mlp(engine["gan_generator"], z, dtype, "tanh")
        completed = _apply_mlp(engine["gan_decoder"], clean_gfv,
                               dtype).reshape(bsz, -1, 3)
        ae_recon = _apply_mlp(engine["decoder"], noisy_gfv,
                              dtype).reshape(bsz, -1, 3)
        both_gfv = torch.cat([clean_gfv, noisy_gfv], dim=0)
    else:
        # one (2B, .) pass through the shared decoder for both branches
        clean_gfv = _apply_mlp(engine["generator"], z, dtype, "tanh")
        both_gfv = torch.cat([clean_gfv, noisy_gfv], dim=0)
        both_pc = _apply_mlp(engine["decoder"], both_gfv,
                             dtype).reshape(2 * bsz, -1, 3)
        completed, ae_recon = both_pc[:bsz], both_pc[bsz:]
    results = {
        "noisy_gfv": noisy_gfv,
        "z_vector": z,
        "clean_gfv": clean_gfv,
        "completed_pc": completed,
        "ae_reconstruction": ae_recon,
    }
    if hybrid:
        def scores():
            both = _apply_discriminator(engine["discriminator"], both_gfv,
                                        dtype)
            return both[:bsz], both[bsz:]

        results.update(gate(completed, ae_recon, gate_mode, scores, gate_bias))
    return results
