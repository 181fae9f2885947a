"""Fused PointNet-encoder inference: BN folding and kernels K1 and K6
(gan_rl_3d_tpu/ops/encoder_kernel.py).

BatchNorm (eval mode) folds into the preceding dense layer:
  y = (xW + b) * g + c  ==  x(W*g) + (b*g + c),  g = scale/sqrt(var+eps).

``fused_encoder_pool`` applies the folded point-MLP and the masked global
max-pool; ``fused_encoder_pool_int8`` does the same with the int8 bundle of
``ops.quantize.quantize_encoder``, which K6 reads as laid out by
``pack_int8_encoder`` (once per bundle). On a CUDA tensor they launch the
hand-written kernels ``csrc/encoder_pool.cu`` (K1) and
``csrc/encoder_pool_int8.cu`` (K6); on a CPU tensor they run
``fused_encoder_pool_plain`` and ``fused_encoder_pool_int8_plain``, the
same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import collections
import ctypes
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from gan_rl_3d_tpu_torch.ops import _cuda
from gan_rl_3d_tpu_torch.ops.quantize import div127, int8_matmul

Tensor = torch.Tensor

_MAX_LAYERS = 8
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper
# K1's instances: point tiles, the flagship's first; the 128-point one
# stages its weights in two slabs of 2048 f32 (csrc/encoder_pool.cu)
_TILES = (128, 32)
_SLAB_WORDS = 2048


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


def encoder_smem(dims, tile: int) -> int:
    """Shared-memory bytes of K1's ``tile``-point instance for the widths
    ``dims`` (3, C_1, ..., C_L), as ``csrc/encoder_pool.cu::make_layout``
    lays it out: one activation buffer for the inputs of the even layers,
    one for the odd ones (the last output is pooled from registers), the
    weight slabs of a staged instance, one valid flag a point."""
    dims = list(dims)[:-1]
    words = (max(dims[0::2]) + max(dims[1::2], default=0) + 1) * tile
    if tile >= 128:
        words += 2 * _SLAB_WORDS
    return 4 * words


def encoder_tile(dims) -> int:
    """The point tile of the K1 instance that takes the widths ``dims``: the
    largest whose shared memory fits a block, or ValueError."""
    for tile in _TILES:
        if encoder_smem(dims, tile) <= _MAX_SMEM:
            return tile
    raise ValueError(
        f"layer widths {tuple(dims)} exceed K1's shared memory: at its "
        f"smallest tile of {_TILES[-1]} points it needs (the widest input "
        "of an even layer + the widest of an odd layer + 1) x "
        f"{_TILES[-1]} x 4 = {encoder_smem(dims, _TILES[-1])} bytes, more "
        f"than the {_MAX_SMEM} a block may use")


def _lib() -> ctypes.CDLL:
    lib = _cuda.library("encoder_pool")
    if lib.grl_encoder_pool.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p,
                                         p]
        lib.grl_encoder_pool.restype = i
        lib.grl_encoder_pool_registers.argtypes = [i, i, i]
        lib.grl_encoder_pool_registers.restype = i
    return lib


def encoder_pool_registers(tile: int, compute_dtype: torch.dtype,
                           masked: bool) -> int:
    """Registers a thread of K1's instance (``cudaFuncGetAttributes``)."""
    return _lib().grl_encoder_pool_registers(
        tile, int(compute_dtype == torch.bfloat16), int(masked))


def _fused_encoder_pool_cuda(pc: Tensor, folded_layers, mask: Optional[Tensor],
                             compute_dtype: torch.dtype) -> Tensor:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    if pc.ndim != 3 or pc.shape[-1] != 3:
        raise ValueError(f"pc must be (B, N, 3), got {tuple(pc.shape)}")
    bsz, n, _ = pc.shape
    if bsz < 1 or n < 1:
        raise ValueError(f"empty batch {tuple(pc.shape)}")
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
    tile = encoder_tile(dims)
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
            int(compute_dtype == torch.bfloat16), tile, bsz, n,
            bits.data_ptr(),
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


def pad_int8_encoder(qenc: dict) -> dict:
    """The bundle with every width padded to a multiple of 32 (the depth of
    K6's ``mma``): zero columns of ``w0`` and ``b0``, zero rows and columns
    of each ``wq``, ``s_w = 1`` and ``b = 0`` in the padded channels. A
    padded channel is ReLU(0) = 0, which moves neither a row maximum nor a
    product, so the plain version gives the same bits on it (with the
    outputs past C_last dropped). Raises ValueError on a malformed bundle."""
    w0, b0 = qenc["layer0"]
    layers = qenc["layers_q"]
    if not 1 <= len(layers) <= _MAX_LAYERS:
        raise ValueError(f"1..{_MAX_LAYERS} quantized layers supported, got "
                         f"{len(layers)}")
    w0 = w0.float()
    b0 = b0.float().reshape(-1)
    if w0.ndim != 2 or w0.shape[0] != 3 or b0.shape != (w0.shape[1],):
        raise ValueError(f"layer0 must be (3, C0) and (C0,), got "
                         f"{tuple(w0.shape)}, {tuple(b0.shape)}")
    device = w0.device
    k, kp = w0.shape[1], _pad32(w0.shape[1])
    w0p = w0.new_zeros((3, kp))
    w0p[:, :k] = w0
    b0p = b0.new_zeros(kp)
    b0p[:k] = b0
    out = []
    for wq, s_w, b in layers:
        if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[0] != k:
            raise ValueError(f"quantized weight must be int8 ({k}, C), got "
                             f"{wq.dtype} {tuple(wq.shape)}")
        c, cp = wq.shape[1], _pad32(wq.shape[1])
        s_w = s_w.float().reshape(-1)
        b = b.float().reshape(-1)
        if s_w.shape != (c,) or b.shape != (c,):
            raise ValueError(f"scale and bias must have {c} entries")
        if any(x.device != device for x in (b0, wq, s_w, b)):
            raise ValueError("the bundle's tensors lie on different devices")
        wqp = wq.new_zeros((kp, cp))
        wqp[:k, :c] = wq
        swp = s_w.new_ones((1, cp))
        swp[0, :c] = s_w
        bp = b.new_zeros((1, cp))
        bp[0, :c] = b
        out.append((wqp, swp, bp))
        k, kp = c, cp
    return {"layer0": (w0p, b0p.reshape(1, -1)), "layers_q": out}


def _pad32(width: int) -> int:
    return -(-width // 32) * 32


# Slot 16h + 4t + i of each 32-wide chunk of K holds weight row
# 16h + 8(i // 2) + 2t + i % 2: where the m16n8k32 A fragment wants thread
# t's byte i, the accumulator layout of the previous layer left that
# thread's output (csrc/encoder_pool_int8.cu).
INT8_K_ORDER = tuple(16 * h + 8 * (i // 2) + 2 * t + i % 2
                     for h in range(2) for t in range(4) for i in range(4))
INT8_MAX_WIDTH = 256  # a 16 x 256 slab's accumulators fill 128 registers


@dataclass(eq=False)
class PackedInt8Encoder:
    """K6's shared-memory image of a bundle (``pack_int8_encoder``)."""

    data: Tensor               # uint8, bytes as csrc/encoder_pool_int8.cu
    dims: Tuple[int, ...]      # padded widths: C0, then each layer's C
    c_last: int                # the unpadded output width

    def __post_init__(self):
        self.c_dims = (ctypes.c_int * len(self.dims))(*self.dims)


def pack_int8_encoder(qenc: dict) -> PackedInt8Encoder:
    """Pad the bundle (``pad_int8_encoder``) and lay it out as K6 reads it:
    w0 (3, C0) and b0 (C0,) f32, then per layer s_w (C,) and b (C,) f32 and
    the int8 weights in fragment order, [C/8][K/32][32 lanes][8 bytes]:
    lane 4g + t holds rows 16h + 4t + i (h = 0, 1; i = 0..3, in
    ``INT8_K_ORDER``) of column 8j + g, the m16n8k32 B operand. Runs on the
    bundle's device. Raises ValueError where a padded width exceeds
    ``INT8_MAX_WIDTH`` or the image a block's shared memory."""
    padded = pad_int8_encoder(qenc)
    w0, b0 = padded["layer0"]
    dims = (w0.shape[1], *(wq.shape[1] for wq, _, _ in padded["layers_q"]))
    if max(dims) > INT8_MAX_WIDTH:
        raise ValueError(
            f"K6 keeps a 16-point slab's outputs of a layer in registers: "
            f"widths up to {INT8_MAX_WIDTH} after padding to 32, got {dims}")
    order = torch.tensor(INT8_K_ORDER, device=w0.device)
    parts = [w0.reshape(-1), b0.reshape(-1)]
    for wq, s_w, b in padded["layers_q"]:
        kp, cp = wq.shape
        frag = (wq.reshape(kp // 32, 32, cp)[:, order, :]
                .reshape(kp // 32, 2, 4, 4, cp // 8, 8)
                .permute(4, 0, 5, 2, 1, 3))      # (j, kc, g, t, h, i)
        parts += [s_w.reshape(-1), b.reshape(-1), frag.reshape(-1)]
    data = torch.cat([x.contiguous().view(torch.uint8) for x in parts])
    if data.numel() > _MAX_SMEM:
        raise ValueError(
            f"widths {dims} exceed K6's shared memory: the packed bundle "
            f"(16 C0 + the sum over layers of 8 C + K C bytes) is "
            f"{data.numel()} bytes, more than the {_MAX_SMEM} a block may "
            "use")
    return PackedInt8Encoder(data, dims, qenc["layers_q"][-1][0].shape[1])


class Int8PackMemo:
    """``pack_int8_encoder`` once per bundle: an entry is keyed by the
    identity, storage, version counter and shape of every tensor of the
    bundle and holds weak references to them, so an in-place edit of a
    weight (which bumps its version) or a new bundle at a freed address
    repacks. ``packs`` counts the packings. Holds the last eight."""

    def __init__(self):
        self.packs = 0
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def __call__(self, qenc: dict) -> PackedInt8Encoder:
        leaves = [*qenc["layer0"],
                  *(x for layer in qenc["layers_q"] for x in layer)]
        key = tuple((id(x), x.data_ptr(), x._version, tuple(x.shape))
                    for x in leaves)
        hit = self._entries.get(key)
        if hit is not None and all(r() is x for r, x in zip(hit[0], leaves)):
            self._entries.move_to_end(key)
            return hit[1]
        packed = pack_int8_encoder(qenc)
        self.packs += 1
        self._entries[key] = ([weakref.ref(x) for x in leaves], packed)
        while len(self._entries) > 8:
            self._entries.popitem(last=False)
        return packed


packed_int8_encoder = Int8PackMemo()
_SM_COUNTS: dict = {}


def _int8_lib() -> ctypes.CDLL:
    lib = _cuda.library("encoder_pool_int8")
    if lib.grl_encoder_pool_int8.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool_int8.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                              p, p, p]
        lib.grl_encoder_pool_int8.restype = i
        lib.grl_encoder_pool_int8_attributes.argtypes = [
            i, i, ctypes.POINTER(ctypes.c_int)]
        lib.grl_encoder_pool_int8_attributes.restype = i
        lib.grl_encoder_pool_int8_divide_check.argtypes = [
            ctypes.c_longlong, ctypes.c_ulonglong, p, p]
        lib.grl_encoder_pool_int8_divide_check.restype = i
    return lib


def int8_divide_mismatches(n: int, seed: int, device) -> int:
    """How many of ``n`` quotients drawn from ``seed`` K6's divide (a
    refined reciprocal and one correction) gives with other bits than the
    IEEE divide ``__fdiv_rn``, on the card (expected 0)."""
    device = torch.device(device)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    lib = _int8_lib()
    with torch.cuda.device(device):
        err = lib.grl_encoder_pool_int8_divide_check(
            n, seed, count.data_ptr(), torch.cuda.current_stream(
                device).cuda_stream)
    _cuda.check(err, lib, "encoder_pool_int8 divide check")
    return int(count.item())


def encoder_pool_int8_attributes(masked: bool, flagship: bool
                                 ) -> Tuple[int, int]:
    """(registers a thread, local-memory bytes) of K6's instance, from
    ``cudaFuncGetAttributes``; ``flagship`` picks the instance with the
    flagship widths fixed at compile time."""
    local = ctypes.c_int(0)
    regs = _int8_lib().grl_encoder_pool_int8_attributes(
        int(masked), int(flagship), ctypes.byref(local))
    return regs, local.value


def _fused_encoder_pool_int8_cuda(pc: Tensor, qenc: dict,
                                  mask: Optional[Tensor]) -> Tensor:
    if pc.ndim != 3 or pc.shape[-1] != 3:
        raise ValueError(f"pc must be (B, N, 3), got {tuple(pc.shape)}")
    bsz, n, _ = pc.shape
    if bsz < 1 or n < 1:
        raise ValueError(f"empty batch {tuple(pc.shape)}")
    _cuda.require_cuda(pc, "fused_encoder_pool_int8")
    w0, b0 = qenc["layer0"]
    _cuda.refuse_grad("fused_encoder_pool_int8", "K6 serves the int8 "
                      "inference engine", pc, w0, b0)
    packed = packed_int8_encoder(qenc)
    if packed.data.device != pc.device:
        raise ValueError("weights must lie on the input's device")
    pc = pc.to(torch.float32).contiguous()
    if mask is not None:
        if mask.shape != (bsz, n) or mask.device != pc.device:
            raise ValueError(f"mask must be (B, N) = {(bsz, n)} on "
                             f"{pc.device}, got {tuple(mask.shape)}")
        mask = mask.to(torch.float32).contiguous()
    index = pc.device.index
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = _SM_COUNTS[index] = torch.cuda.get_device_properties(
            pc.device).multi_processor_count
    bits = torch.empty((bsz, packed.c_last), dtype=torch.int32,
                       device=pc.device)
    out = torch.empty((bsz, packed.c_last), dtype=torch.float32,
                      device=pc.device)
    lib = _int8_lib()
    with torch.cuda.device(pc.device):
        err = lib.grl_encoder_pool_int8(
            pc.data_ptr(), mask.data_ptr() if mask is not None else None,
            packed.data.data_ptr(), ctypes.addressof(packed.c_dims),
            len(packed.dims) - 1, packed.c_last, bsz, n, sms, index,
            bits.data_ptr(), out.data_ptr(), _cuda.stream_of(pc))
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
