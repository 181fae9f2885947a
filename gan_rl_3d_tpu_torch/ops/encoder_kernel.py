"""Fused PointNet-encoder inference: BN folding and kernels K1 and K6
(gan_rl_3d_tpu/ops/encoder_kernel.py).

BatchNorm (eval mode) folds into the preceding dense layer:
  y = (xW + b) * g + c  ==  x(W*g) + (b*g + c),  g = scale/sqrt(var+eps).

``fused_encoder_pool`` applies the folded point-MLP and the masked global
max-pool; ``fused_encoder_pool_int8`` does the same with the int8 bundle of
``ops.quantize.quantize_encoder``. On a CUDA tensor they launch the
hand-written kernels ``csrc/encoder_pool.cu`` (K1) and
``csrc/encoder_pool_int8.cu`` (K6); on a CPU tensor they run
``fused_encoder_pool_plain`` and ``fused_encoder_pool_int8_plain``, the
same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.ops.quantize import div127, int8_matmul

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


def fused_encoder_pool_int8_plain(pc: Tensor, qenc: dict,
                                  mask: Optional[Tensor] = None) -> Tensor:
    """Plain version of K6: pc (B, N, 3)[, mask (B, N)] -> (B, C_last) f32.

    The arithmetic of the TPU kernel (encoder_kernel.py:163-201): layer 0
    as three f32 products; per quantized layer the row scale
    ``max(max |y|, 1e-12) / 127`` (the kernel's clamp order, which differs
    from ``quantize_rows`` only for rows whose maximum is below 1.27e-10),
    ``clip(round(y / s_x), +-127)``, the exact integer product and
    ``relu((acc * s_x) * s_w + b)``; padded points -inf, then the max."""
    x = pc.float()
    w0, b0 = qenc["layer0"]
    y = torch.relu((x[..., 0:1] * w0[0] + x[..., 1:2] * w0[1]
                    + x[..., 2:3] * w0[2]) + b0.reshape(-1))
    for wq, s_w, b in qenc["layers_q"]:
        s_x = div127(torch.clamp(y.abs().amax(dim=-1, keepdim=True),
                                 min=1e-12))
        xq = torch.clamp(torch.round(y / s_x), -127, 127)
        y = torch.relu(int8_matmul(xq, wq) * s_x * s_w.reshape(-1)
                       + b.reshape(-1))
    if mask is not None:
        y = torch.where(mask[..., None] > 0, y,
                        torch.tensor(float("-inf"), device=y.device))
    return y.amax(dim=-2)


def pack_int8_weight(wq: Tensor) -> Tensor:
    """(K, C) int8 -> (K / 4, C) int32 whose byte j of word [k4, c] is
    wq[4 k4 + j, c] (little-endian): one word feeds one __dp4a in K6."""
    k, c = wq.shape
    return (wq.reshape(k // 4, 4, c).transpose(1, 2).contiguous()
            .view(torch.int32).reshape(k // 4, c))


def _int8_lib() -> ctypes.CDLL:
    lib = _cuda.library("encoder_pool_int8")
    if lib.grl_encoder_pool_int8.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool_int8.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                              i, p, p, p]
        lib.grl_encoder_pool_int8.restype = i
        lib.grl_encoder_pool_int8_smem.argtypes = [p, i]
        lib.grl_encoder_pool_int8_smem.restype = i
    return lib


def _fused_encoder_pool_int8_cuda(pc: Tensor, qenc: dict,
                                  mask: Optional[Tensor]) -> Tensor:
    if pc.ndim != 3 or pc.shape[-1] != 3:
        raise ValueError(f"pc must be (B, N, 3), got {tuple(pc.shape)}")
    bsz, n, _ = pc.shape
    if bsz < 1 or n < 1:
        raise ValueError(f"empty batch {tuple(pc.shape)}")
    _cuda.require_cuda(pc, "fused_encoder_pool_int8")
    layers = qenc["layers_q"]
    if not 1 <= len(layers) <= _MAX_LAYERS:
        raise ValueError(f"1..{_MAX_LAYERS} quantized layers supported, got "
                         f"{len(layers)}")
    w0, b0 = qenc["layer0"]
    w0 = w0.float().contiguous()
    b0 = b0.float().reshape(-1).contiguous()
    _cuda.refuse_grad("fused_encoder_pool_int8", "K6 serves the int8 "
                      "inference engine", pc, w0, b0)
    if w0.ndim != 2 or w0.shape[0] != 3 or b0.shape != (w0.shape[1],):
        raise ValueError(f"layer0 must be (3, C0) and (C0,), got "
                         f"{tuple(w0.shape)}, {tuple(b0.shape)}")
    dims, packed, scales, biases = [w0.shape[1]], [], [], []
    for wq, s_w, b in layers:
        if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[0] != dims[-1]:
            raise ValueError(f"quantized weight must be int8 ({dims[-1]}, C),"
                             f" got {wq.dtype} {tuple(wq.shape)}")
        c = wq.shape[1]
        s_w = s_w.float().reshape(-1).contiguous()
        b = b.float().reshape(-1).contiguous()
        if s_w.shape != (c,) or b.shape != (c,):
            raise ValueError(f"scale and bias must have {c} entries")
        if wq.shape[0] % 4 or c % 8:
            raise ValueError(f"K6 takes K a multiple of 4 and C of 8, got "
                             f"({wq.shape[0]}, {c})")
        packed.append(pack_int8_weight(wq))
        scales.append(s_w)
        biases.append(b)
        dims.append(c)
    if any(x.device != pc.device for x in (w0, b0, *packed, *scales, *biases)):
        raise ValueError("weights must lie on the input's device")
    lib = _int8_lib()
    c_dims = (ctypes.c_int * len(dims))(*dims)
    smem = lib.grl_encoder_pool_int8_smem(ctypes.addressof(c_dims), len(layers))
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"widths {dims} exceed K6's shared memory")
    pc = pc.to(torch.float32).contiguous()
    if mask is not None:
        if mask.shape != (bsz, n) or mask.device != pc.device:
            raise ValueError(f"mask must be (B, N) = {(bsz, n)} on "
                             f"{pc.device}, got {tuple(mask.shape)}")
        mask = mask.to(torch.float32).contiguous()
    bits = torch.empty((bsz, dims[-1]), dtype=torch.int32, device=pc.device)
    out = torch.empty((bsz, dims[-1]), dtype=torch.float32, device=pc.device)
    n_q = len(layers)
    w_ptrs = (ctypes.c_void_p * n_q)(*[w.data_ptr() for w in packed])
    s_ptrs = (ctypes.c_void_p * n_q)(*[s.data_ptr() for s in scales])
    b_ptrs = (ctypes.c_void_p * n_q)(*[b.data_ptr() for b in biases])
    with torch.cuda.device(pc.device):
        err = lib.grl_encoder_pool_int8(
            pc.data_ptr(), mask.data_ptr() if mask is not None else None,
            w0.data_ptr(), b0.data_ptr(), ctypes.addressof(w_ptrs),
            ctypes.addressof(s_ptrs), ctypes.addressof(b_ptrs),
            ctypes.addressof(c_dims), n_q, bsz, n, bits.data_ptr(),
            out.data_ptr(), _cuda.stream_of(pc))
    _cuda.check(err, lib, "encoder_pool_int8")
    _cuda.launch_counts["encoder_pool_int8"] += 1
    return out


def fused_encoder_pool_int8(pc: Tensor, qenc: dict,
                            mask: Optional[Tensor] = None) -> Tensor:
    """pc (B, N, 3)[, mask (B, N)] -> pooled features (B, C_last) f32
    through the int8 bundle ``qenc``.

    K6 (``csrc/encoder_pool_int8.cu``) on a CUDA tensor, the plain version
    on a CPU tensor (encoder_kernel.py:204-258)."""
    if pc.device.type == "cpu":
        return fused_encoder_pool_int8_plain(pc, qenc, mask)
    return _fused_encoder_pool_int8_cuda(pc, qenc, mask)


def apply_head(pooled: Tensor, head) -> Tensor:
    """The folded 128->128 head as one f32 matmul + ReLU."""
    hw, hb = head
    return torch.relu(pooled @ hw.float() + hb.float())


def encode_fused(pc: Tensor, folded: dict, mask: Optional[Tensor] = None, *,
                 compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """Folded inference encoder: K1 pool, then the head
    (encoder_kernel.py:295-317) -> GFV (B, 128)."""
    return apply_head(fused_encoder_pool(pc, folded["layers"], mask,
                                         compute_dtype=compute_dtype),
                      folded["head"])
