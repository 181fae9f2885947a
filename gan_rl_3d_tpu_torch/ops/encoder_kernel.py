"""Fused PointNet-encoder inference: BN folding and kernel K1
(gan_rl_3d_tpu/ops/encoder_kernel.py).

BatchNorm (eval mode) folds into the preceding dense layer:
  y = (xW + b) * g + c  ==  x(W*g) + (b*g + c),  g = scale/sqrt(var+eps).

``fused_encoder_pool`` applies the folded point-MLP and the masked global
max-pool. On a CUDA tensor it launches the hand-written kernel
``csrc/encoder_pool.cu``; on a CPU tensor it runs
``fused_encoder_pool_plain``, the same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.ops import _cuda

Tensor = torch.Tensor

_MAX_LAYERS = 8
_TILE = 32
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def fold_bn(dense_params: dict, bn_params: dict, bn_state: dict,
            eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """Fold eval-mode BatchNorm into the preceding dense layer
    (encoder_kernel.py:34-41)."""
    g = bn_params["scale"] * torch.rsqrt(bn_state["var"] + eps)
    c = bn_params["bias"] - bn_state["mean"] * g
    return dense_params["w"] * g[None, :], dense_params["b"] * g + c


def fold_encoder_params(encoder_params: dict, encoder_state: dict,
                        dtype: torch.dtype = torch.float32) -> dict:
    """Fold the point-MLP (cast to ``dtype``) and the head (kept f32)
    into plain (w, b) pairs (encoder_kernel.py:44-54)."""
    layers = []
    for p, s in zip(encoder_params["point_mlp"], encoder_state["point_mlp"]):
        w, b = fold_bn(p["dense"], p["bn"], s["bn"])
        layers.append((w.to(dtype), b.to(dtype)))
    head_p = encoder_params["head"][0]
    head_s = encoder_state["head"][0]
    return {"layers": layers,
            "head": fold_bn(head_p["dense"], head_p["bn"], head_s["bn"])}


def fused_encoder_pool_plain(pc: Tensor, folded_layers: List[Tuple[Tensor, Tensor]],
                             mask: Optional[Tensor] = None, *,
                             compute_dtype: torch.dtype = torch.float32
                             ) -> Tensor:
    """Plain version of K1: pc (B, N, 3)[, mask (B, N)] -> (B, C_last) f32.

    Rounds where the TPU kernel rounds (encoder_kernel.py:81-96): the input
    and each layer's output to ``compute_dtype``; products of
    ``compute_dtype`` values summed in f32; layer 0 as three f32 products."""
    x = pc.to(compute_dtype)
    for i, (w, b) in enumerate(folded_layers):
        wf = w.to(compute_dtype).float()
        xf = x.float()
        if i == 0 and w.shape[0] == 3:
            y = (xf[..., 0:1] * wf[0] + xf[..., 1:2] * wf[1]
                 + xf[..., 2:3] * wf[2]) + b.float()
        else:
            y = torch.matmul(xf, wf) + b.float()
        x = torch.relu(y).to(compute_dtype)
    x = x.float()
    if mask is not None:
        x = torch.where(mask[..., None] > 0, x,
                        torch.tensor(float("-inf"), device=x.device))
    return x.amax(dim=-2)


def _lib() -> ctypes.CDLL:
    lib = _cuda.library("encoder_pool")
    if lib.grl_encoder_pool.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p]
        lib.grl_encoder_pool.restype = i
    return lib


def _fused_encoder_pool_cuda(pc: Tensor, folded_layers, mask: Optional[Tensor],
                             compute_dtype: torch.dtype) -> Tensor:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    if pc.ndim != 3 or pc.shape[-1] != 3:
        raise ValueError(f"pc must be (B, N, 3), got {tuple(pc.shape)}")
    bsz, n, _ = pc.shape
    if not (1 <= bsz <= 65535 and n >= 1):
        raise ValueError(f"batch must be in [1, 65535] and N >= 1, got "
                         f"{tuple(pc.shape)}")
    n_layers = len(folded_layers)
    if not 1 <= n_layers <= _MAX_LAYERS:
        raise ValueError(f"1..{_MAX_LAYERS} layers supported, got {n_layers}")
    _cuda.require_cuda(pc, "fused_encoder_pool")
    weights = [w.to(compute_dtype).contiguous() for w, _ in folded_layers]
    biases = [b.to(torch.float32).contiguous() for _, b in folded_layers]
    _cuda.refuse_grad("fused_encoder_pool", "K1 serves the folded "
                      "inference engine; training runs the unfolded encoder",
                      pc, *weights, *biases)
    dims = [3]
    for w, b in zip(weights, biases):
        if w.ndim != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"layer shapes do not chain: w {tuple(w.shape)}, "
                             f"b {tuple(b.shape)} after width {dims[-1]}")
        if w.device != pc.device or b.device != pc.device:
            raise ValueError("weights must lie on the input's device")
        dims.append(w.shape[1])
    if 2 * max(dims) * _TILE * 4 > _MAX_SMEM:
        raise ValueError(f"layer width {max(dims)} exceeds the kernel's "
                         "shared-memory tile")
    pc = pc.to(torch.float32).contiguous()
    if mask is not None:
        if mask.shape != (bsz, n) or mask.device != pc.device:
            raise ValueError(f"mask must be (B, N) = {(bsz, n)} on "
                             f"{pc.device}, got {tuple(mask.shape)}")
        mask = mask.to(torch.float32).contiguous()
    c_out = dims[-1]
    bits = torch.empty((bsz, c_out), dtype=torch.int32, device=pc.device)
    out = torch.empty((bsz, c_out), dtype=torch.float32, device=pc.device)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in biases])
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    lib = _lib()
    with torch.cuda.device(pc.device):
        err = lib.grl_encoder_pool(
            pc.data_ptr(), mask.data_ptr() if mask is not None else None,
            ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
            ctypes.addressof(c_dims), n_layers,
            int(compute_dtype == torch.bfloat16), bsz, n, bits.data_ptr(),
            out.data_ptr(), _cuda.stream_of(pc))
    _cuda.check(err, lib, "encoder_pool")
    name = "f32" if compute_dtype == torch.float32 else "bf16"
    _cuda.launch_counts[f"encoder_pool_{name}"] += 1
    return out


def fused_encoder_pool(pc: Tensor, folded_layers: List[Tuple[Tensor, Tensor]],
                       mask: Optional[Tensor] = None, *,
                       compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """pc (B, N, 3)[, mask (B, N)] -> pooled features (B, C_last) f32.

    K1 (``csrc/encoder_pool.cu``) on a CUDA tensor, the plain version on a
    CPU tensor (encoder_kernel.py:101-160)."""
    if pc.device.type == "cpu":
        return fused_encoder_pool_plain(pc, folded_layers, mask,
                                        compute_dtype=compute_dtype)
    return _fused_encoder_pool_cuda(pc, folded_layers, mask, compute_dtype)


def encode_fused(pc: Tensor, folded: dict, mask: Optional[Tensor] = None, *,
                 compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """Folded inference encoder: K1 pool, then the 128->128 head as one
    f32 matmul + ReLU (encoder_kernel.py:295-317) -> GFV (B, 128)."""
    pooled = fused_encoder_pool(pc, folded["layers"], mask,
                                compute_dtype=compute_dtype)
    hw, hb = folded["head"]
    return torch.relu(pooled @ hw.float() + hb.float())
