"""Fused PointNet-encoder inference: BN folding and kernels K1 and K6
(gan_rl_3d_tpu/ops/encoder_kernel.py).

BatchNorm (eval mode) folds into the preceding dense layer:
  y = (xW + b) * g + c  ==  x(W*g) + (b*g + c),  g = scale/sqrt(var+eps).

``fused_encoder_pool`` applies the folded point-MLP and the masked global
max-pool; ``fused_encoder_pool_int8`` does the same with the int8 bundle of
``ops.quantize.quantize_encoder``. On a CUDA tensor they launch the
hand-written kernels, each instance picked by the layer widths, never on a
failure:

* K1 f32: ``csrc/encoder_pool.cu`` (CUDA cores; ``encoder_tile`` picks
  its point tile);
* K1 bf16: ``csrc/encoder_pool_bf16.cu`` on the bf16 tensor cores where
  ``bf16_instance`` says ``"mma"``, its weights laid out once per engine
  by ``pack_bf16_encoder``; the CUDA-core bf16 variant of
  ``csrc/encoder_pool.cu`` for wider layers;
* K6: ``csrc/encoder_pool_int8.cu`` on the int8 tensor cores, or
  ``csrc/encoder_pool_int8_wide.cu`` for wider layers (``int8_instance``),
  both reading the bundle as ``pack_int8_encoder`` lays it out once per
  bundle.

On a CPU tensor they run ``fused_encoder_pool_plain`` and
``fused_encoder_pool_int8_plain``, the same arithmetic in plain PyTorch.
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
# the tensor-core instances of K1 bf16 and K6 keep a 16-point slab's
# outputs of a layer in registers: a 16 x 256 slab's accumulators fill 128
MMA_MAX_WIDTH = 256


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


def _pad(width: int, multiple: int) -> int:
    return -(-width // multiple) * multiple


def bf16_image_bytes(padded) -> int:
    """Bytes of ``pack_bf16_encoder``'s image for the padded widths (C0,
    C1, ..., C_L): w0 and b0 f32, then per layer its f32 bias and bf16
    weights."""
    return 16 * padded[0] + sum(4 * c + 2 * k * c
                                for k, c in zip(padded[:-1], padded[1:]))


def bf16_instance(dims) -> str:
    """The K1 bf16 instance that takes the widths ``dims`` (3, C0, ...,
    C_L): ``"mma"``, the tensor-core one, where every width padded to 16 is
    at most ``MMA_MAX_WIDTH`` and the image fits a block's shared memory;
    else ``"wide"``, the CUDA-core one (its tile from ``encoder_tile``);
    ValueError where neither takes them."""
    padded = tuple(_pad(c, 16) for c in dims[1:])
    if (max(padded) <= MMA_MAX_WIDTH
            and bf16_image_bytes(padded) <= _MAX_SMEM):
        return "mma"
    encoder_tile(dims)
    return "wide"


@dataclass(eq=False)
class PackedEncoder:
    """A kernel instance's image of an encoder (``pack_bf16_encoder``,
    ``pack_int8_encoder``)."""

    data: Tensor               # uint8, bytes as the instance reads them
    dims: Tuple[int, ...]      # padded widths: C0, then each layer's C
    c_last: int                # the unpadded output width
    instance: str              # "mma" or "wide"

    def __post_init__(self):
        self.c_dims = (ctypes.c_int * len(self.dims))(*self.dims)


def _chain_dims(folded_layers) -> List[int]:
    """(3, C0, ..., C_L) of (w, b) layers, or ValueError."""
    if not 1 <= len(folded_layers) <= _MAX_LAYERS:
        raise ValueError(f"1..{_MAX_LAYERS} layers supported, got "
                         f"{len(folded_layers)}")
    dims = [3]
    for w, b in folded_layers:
        if w.ndim != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"layer shapes do not chain: w {tuple(w.shape)}, "
                             f"b {tuple(b.shape)} after width {dims[-1]}")
        dims.append(w.shape[1])
    return dims


def pack_bf16_encoder(folded_layers: List[Tuple[Tensor, Tensor]]
                      ) -> PackedEncoder:
    """Lay the folded layers out as K1 bf16's tensor-core instance reads
    them, every width padded to 16 with zero weights and zero bias: w0
    (3, C0) as f32 of its bf16 values and b0 (C0,) f32, then per layer b
    (C,) f32 and the bf16 weights in fragment order, [C/8][K/16][32
    lanes][4 values]: lane 4g + t holds rows 16kc + 2t, 2t + 1, 2t + 8 and
    2t + 9 of column 8j + g, the m16n8k16 B operand. Runs on the layers'
    device. Raises ValueError where ``bf16_instance`` does not pick
    ``"mma"``."""
    dims = _chain_dims(folded_layers)
    if bf16_instance(dims) != "mma":
        raise ValueError(
            f"widths {tuple(dims)} exceed K1 bf16's tensor-core instance: "
            f"widths up to {MMA_MAX_WIDTH} after padding to 16, and an "
            f"image of at most {_MAX_SMEM} bytes")
    w0, b0 = folded_layers[0]
    k, kp = w0.shape[1], _pad(w0.shape[1], 16)
    w0p = w0.new_zeros((3, kp), dtype=torch.float32)
    w0p[:, :k] = w0.to(torch.bfloat16).float()
    b0p = w0p.new_zeros(kp)
    b0p[:k] = b0.float()
    parts, padded = [w0p, b0p], [kp]
    for w, b in folded_layers[1:]:
        if w.device != w0.device or b.device != w0.device:
            raise ValueError("the layers lie on different devices")
        c, cp = w.shape[1], _pad(w.shape[1], 16)
        wp = w.new_zeros((kp, cp), dtype=torch.bfloat16)
        wp[:k, :c] = w.to(torch.bfloat16)
        bp = w0p.new_zeros(cp)
        bp[:c] = b.float()
        frag = (wp.reshape(kp // 16, 2, 4, 2, cp // 8, 8)
                .permute(4, 0, 5, 2, 1, 3))      # (j, kc, g, t, h, e)
        parts += [bp, frag]
        padded.append(cp)
        k, kp = c, cp
    data = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                      for x in parts])
    return PackedEncoder(data, tuple(padded), folded_layers[-1][0].shape[1],
                         "mma")


class PackMemo:
    """``pack`` once per set of weights: an entry is keyed by the identity,
    storage, version counter and shape of every tensor that ``leaves``
    returns for it and holds weak references to them, so an in-place edit
    of a weight (which bumps its version) or new weights at a freed
    address repack. ``packs`` counts the packings. Holds the last eight."""

    def __init__(self, pack, leaves):
        self.pack, self.leaves = pack, leaves
        self.packs = 0
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def __call__(self, weights) -> PackedEncoder:
        leaves = self.leaves(weights)
        key = tuple((id(x), x.data_ptr(), x._version, tuple(x.shape))
                    for x in leaves)
        hit = self._entries.get(key)
        if hit is not None and all(r() is x for r, x in zip(hit[0], leaves)):
            self._entries.move_to_end(key)
            return hit[1]
        packed = self.pack(weights)
        self.packs += 1
        self._entries[key] = ([weakref.ref(x) for x in leaves], packed)
        while len(self._entries) > 8:
            self._entries.popitem(last=False)
        return packed


class Bf16PackMemo(PackMemo):
    """``pack_bf16_encoder`` once per engine's folded layers."""

    def __init__(self):
        super().__init__(pack_bf16_encoder,
                         lambda layers: [x for layer in layers for x in layer])


packed_bf16_encoder = Bf16PackMemo()
_SM_COUNTS: dict = {}


def _lib() -> ctypes.CDLL:
    lib = _cuda.library("encoder_pool")
    if lib.grl_encoder_pool.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p,
                                         p, p]
        lib.grl_encoder_pool.restype = i
    return lib


def _bf16_lib() -> ctypes.CDLL:
    lib = _cuda.library("encoder_pool_bf16")
    if lib.grl_encoder_pool_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p,
                                              p, p]
        lib.grl_encoder_pool_bf16.restype = i
        lib.grl_encoder_pool_bf16_attributes.argtypes = [
            i, i, ctypes.POINTER(ctypes.c_int)]
        lib.grl_encoder_pool_bf16_attributes.restype = i
    return lib


def encoder_pool_bf16_attributes(masked: bool, flagship: bool
                                 ) -> Tuple[int, int]:
    """(registers a thread, local-memory bytes) of K1 bf16's tensor-core
    instance, from ``cudaFuncGetAttributes``; ``flagship`` picks the one
    with the flagship widths fixed at compile time."""
    local = ctypes.c_int(0)
    regs = _bf16_lib().grl_encoder_pool_bf16_attributes(
        int(masked), int(flagship), ctypes.byref(local))
    return regs, local.value


def _check_cloud(pc: Tensor, mask: Optional[Tensor], what: str):
    """(pc f32, mask f32 or None), contiguous, or ValueError."""
    if pc.ndim != 3 or pc.shape[-1] != 3:
        raise ValueError(f"pc must be (B, N, 3), got {tuple(pc.shape)}")
    bsz, n, _ = pc.shape
    if bsz < 1 or n < 1:
        raise ValueError(f"empty batch {tuple(pc.shape)}")
    _cuda.require_cuda(pc, what)
    pc = pc.to(torch.float32).contiguous()
    if mask is not None:
        if mask.shape != (bsz, n) or mask.device != pc.device:
            raise ValueError(f"mask must be (B, N) = {(bsz, n)} on "
                             f"{pc.device}, got {tuple(mask.shape)}")
        mask = mask.to(torch.float32).contiguous()
    return pc, mask


def _sm_count(device: torch.device) -> int:
    sms = _SM_COUNTS.get(device.index)
    if sms is None:
        sms = _SM_COUNTS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def encoder_pool_cuda_cores(pc: Tensor,
                            folded_layers: List[Tuple[Tensor, Tensor]],
                            mask: Optional[Tensor] = None, *,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> Tensor:
    """K1's CUDA-core instance (``csrc/encoder_pool.cu``) whatever the
    widths: the f32 path of ``fused_encoder_pool``, its bf16 path for
    layers wider than the tensor-core instance takes, and the bf16
    instance timed beside the tensor-core one at the same widths."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    dims = _chain_dims(folded_layers)
    pc, mask = _check_cloud(pc, mask, "fused_encoder_pool")
    weights = [w.to(compute_dtype).contiguous() for w, _ in folded_layers]
    biases = [b.to(torch.float32).contiguous() for _, b in folded_layers]
    _cuda.refuse_grad("fused_encoder_pool", "K1 serves the folded "
                      "inference engine; training runs the unfolded encoder",
                      pc, *weights, *biases)
    if any(x.device != pc.device for x in (*weights, *biases)):
        raise ValueError("weights must lie on the input's device")
    tile = encoder_tile(dims)
    bsz, n, _ = pc.shape
    n_layers = len(folded_layers)
    bits = torch.empty((bsz, dims[-1]), dtype=torch.int32, device=pc.device)
    out = torch.empty((bsz, dims[-1]), dtype=torch.float32, device=pc.device)
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
            pc.device.index, bits.data_ptr(), out.data_ptr(),
            _cuda.stream_of(pc))
    _cuda.check(err, lib, "encoder_pool")
    name = ("encoder_pool_f32" if compute_dtype == torch.float32
            else "encoder_pool_bf16_wide")
    _cuda.launch_counts[name] += 1
    return out


def _encoder_pool_bf16_mma(pc: Tensor, packed: PackedEncoder,
                          mask: Optional[Tensor] = None) -> Tensor:
    """K1 bf16's tensor-core instance (``csrc/encoder_pool_bf16.cu``) on
    the image ``pack_bf16_encoder`` made."""
    pc, mask = _check_cloud(pc, mask, "fused_encoder_pool")
    if packed.data.device != pc.device:
        raise ValueError("weights must lie on the input's device")
    bsz, n, _ = pc.shape
    bits = torch.empty((bsz, packed.c_last), dtype=torch.int32,
                       device=pc.device)
    out = torch.empty((bsz, packed.c_last), dtype=torch.float32,
                      device=pc.device)
    lib = _bf16_lib()
    with torch.cuda.device(pc.device):
        err = lib.grl_encoder_pool_bf16(
            pc.data_ptr(), mask.data_ptr() if mask is not None else None,
            packed.data.data_ptr(), ctypes.addressof(packed.c_dims),
            len(packed.dims) - 1, packed.c_last, bsz, n, pc.device.index,
            bits.data_ptr(), out.data_ptr(), _cuda.stream_of(pc))
    _cuda.check(err, lib, "encoder_pool_bf16")
    _cuda.launch_counts["encoder_pool_bf16"] += 1
    return out


def fused_encoder_pool(pc: Tensor, folded_layers: List[Tuple[Tensor, Tensor]],
                       mask: Optional[Tensor] = None, *,
                       compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """pc (B, N, 3)[, mask (B, N)] -> pooled features (B, C_last) f32.

    K1 on a CUDA tensor, the plain version on a CPU tensor
    (encoder_kernel.py:101-160). In bf16, the tensor-core instance where
    ``bf16_instance`` picks it (the image packed once per engine,
    ``packed_bf16_encoder``), else the CUDA-core one."""
    if pc.device.type == "cpu":
        return fused_encoder_pool_plain(pc, folded_layers, mask,
                                        compute_dtype=compute_dtype)
    if (compute_dtype == torch.bfloat16
            and bf16_instance(_chain_dims(folded_layers)) == "mma"):
        _cuda.refuse_grad("fused_encoder_pool", "K1 serves the folded "
                          "inference engine; training runs the unfolded "
                          "encoder", pc,
                          *(x for layer in folded_layers for x in layer))
        return _encoder_pool_bf16_mma(
            pc, packed_bf16_encoder(folded_layers), mask)
    return encoder_pool_cuda_cores(pc, folded_layers, mask,
                                   compute_dtype=compute_dtype)


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
    if not 0 <= len(layers) <= _MAX_LAYERS:
        raise ValueError(f"0..{_MAX_LAYERS} quantized layers supported, got "
                         f"{len(layers)}")
    w0 = w0.float()
    b0 = b0.float().reshape(-1)
    if w0.ndim != 2 or w0.shape[0] != 3 or b0.shape != (w0.shape[1],):
        raise ValueError(f"layer0 must be (3, C0) and (C0,), got "
                         f"{tuple(w0.shape)}, {tuple(b0.shape)}")
    device = w0.device
    k, kp = w0.shape[1], _pad(w0.shape[1], 32)
    w0p = w0.new_zeros((3, kp))
    w0p[:, :k] = w0
    b0p = b0.new_zeros(kp)
    b0p[:k] = b0
    out = []
    for wq, s_w, b in layers:
        if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[0] != k:
            raise ValueError(f"quantized weight must be int8 ({k}, C), got "
                             f"{wq.dtype} {tuple(wq.shape)}")
        c, cp = wq.shape[1], _pad(wq.shape[1], 32)
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


# Slot 16h + 4t + i of each 32-wide chunk of K holds weight row
# 16h + 8(i // 2) + 2t + i % 2: where the m16n8k32 A fragment wants thread
# t's byte i, the accumulator layout of the previous layer left that
# thread's outputs (csrc/encoder_pool_int8.cu).
INT8_K_ORDER = tuple(16 * h + 8 * (i // 2) + 2 * t + i % 2
                     for h in range(2) for t in range(4) for i in range(4))
INT8_WIDE_TILE = 32  # points a tile of K6's wide instance


def int8_image_bytes(padded) -> int:
    """Bytes of ``pack_int8_encoder``'s image for the padded widths (C0,
    C1, ..., C_L), in either layout: w0 and b0 f32, then per layer s_w and
    b f32 and the int8 weights."""
    return 16 * padded[0] + sum(8 * c + k * c
                                for k, c in zip(padded[:-1], padded[1:]))


def int8_wide_smem(padded) -> int:
    """Shared-memory bytes of K6's wide instance for the padded widths
    (``csrc/encoder_pool_int8_wide.cu::make_layout``): a tile's f32 rows at
    the widest width, its int8 rows at the widest input, and a scale, a
    point and a valid flag a row."""
    kmax = max(padded[:-1], default=0)
    return 4 * INT8_WIDE_TILE * (max(padded) + kmax // 4 + 5)


def int8_instance(dims) -> str:
    """The K6 instance that takes the widths ``dims`` (3, C0, ..., C_L),
    each padded to 32: ``"mma"`` where every padded width is at most
    ``MMA_MAX_WIDTH`` and the packed bundle fits a block's shared memory;
    else ``"wide"`` where its tile fits; else ValueError."""
    padded = tuple(_pad(c, 32) for c in dims[1:])
    if (max(padded) <= MMA_MAX_WIDTH
            and int8_image_bytes(padded) <= _MAX_SMEM):
        return "mma"
    if int8_wide_smem(padded) <= _MAX_SMEM:
        return "wide"
    raise ValueError(
        f"widths {tuple(dims)} exceed K6's shared memory: its mma.sync "
        f"instance takes widths up to {MMA_MAX_WIDTH} after padding to 32 "
        f"whose packed bundle (16 C0 + the sum over layers of 8 C + K C "
        f"bytes, {int8_image_bytes(padded)} here) fits the {_MAX_SMEM} bytes "
        f"a block may use, its wide instance widths whose {INT8_WIDE_TILE}-"
        f"point tile (4 x {INT8_WIDE_TILE} x (the widest + the widest "
        f"input / 4 + 5) bytes, {int8_wide_smem(padded)} here) fits them")


def pack_int8_encoder(qenc: dict, instance: Optional[str] = None
                      ) -> PackedEncoder:
    """Pad the bundle (``pad_int8_encoder``) and lay it out as K6's
    ``instance`` reads it (by default the one ``int8_instance`` picks): w0
    (3, C0) and b0 (C0,) f32, then per layer s_w (C,) and b (C,) f32 and
    the int8 weights, for ``"mma"`` in fragment order, [C/8][K/32][32
    lanes][8 bytes] (lane 4g + t holds rows 16h + 4t + i, h = 0, 1,
    i = 0..3, in ``INT8_K_ORDER``, of column 8j + g: the m16n8k32 B
    operand), for ``"wide"`` as int32 words of four along K, [K/4][C][4
    bytes] (byte i of word [k4, c] is row 4 k4 + i of column c). Runs on
    the bundle's device. Raises ValueError where the instance does not
    take the widths."""
    padded = pad_int8_encoder(qenc)
    w0, b0 = padded["layer0"]
    dims = (w0.shape[1], *(wq.shape[1] for wq, _, _ in padded["layers_q"]))
    picked = int8_instance((3, *dims))
    if instance not in (None, picked) and not (
            instance == "wide" and int8_wide_smem(dims) <= _MAX_SMEM):
        raise ValueError(f"K6's {instance} instance does not take the "
                         f"widths {dims}; they take the {picked} one")
    instance = instance or picked
    order = torch.tensor(INT8_K_ORDER, device=w0.device)
    parts = [w0.reshape(-1), b0.reshape(-1)]
    for wq, s_w, b in padded["layers_q"]:
        kp, cp = wq.shape
        if instance == "mma":
            w = (wq.reshape(kp // 32, 32, cp)[:, order, :]
                 .reshape(kp // 32, 2, 4, 4, cp // 8, 8)
                 .permute(4, 0, 5, 2, 1, 3))      # (j, kc, g, t, h, i)
        else:
            w = wq.reshape(kp // 4, 4, cp).permute(0, 2, 1)  # (k4, c, i)
        parts += [s_w.reshape(-1), b.reshape(-1), w.reshape(-1)]
    data = torch.cat([x.contiguous().view(torch.uint8) for x in parts])
    w_last = (qenc["layers_q"][-1][0] if qenc["layers_q"]
              else qenc["layer0"][0])
    return PackedEncoder(data, dims, w_last.shape[1], instance)


class Int8PackMemo(PackMemo):
    """``pack_int8_encoder`` once per bundle."""

    def __init__(self):
        super().__init__(pack_int8_encoder, lambda qenc: [
            *qenc["layer0"], *(x for layer in qenc["layers_q"]
                               for x in layer)])


packed_int8_encoder = Int8PackMemo()


def _int8_lib(instance: str = "mma") -> ctypes.CDLL:
    if instance == "wide":
        lib = _cuda.library("encoder_pool_int8_wide")
        if lib.grl_encoder_pool_int8_wide.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.grl_encoder_pool_int8_wide.argtypes = [p, p, p, p, i, i, i,
                                                       i, i, p, p, p]
            lib.grl_encoder_pool_int8_wide.restype = i
        return lib
    lib = _cuda.library("encoder_pool_int8")
    if lib.grl_encoder_pool_int8.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grl_encoder_pool_int8.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                              p, p, p]
        lib.grl_encoder_pool_int8.restype = i
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


def encoder_pool_int8_packed(pc: Tensor, packed: PackedEncoder,
                             mask: Optional[Tensor] = None) -> Tensor:
    """K6's instance ``packed.instance`` on the image ``pack_int8_encoder``
    made: ``csrc/encoder_pool_int8.cu`` (``"mma"``) or
    ``csrc/encoder_pool_int8_wide.cu`` (``"wide"``)."""
    pc, mask = _check_cloud(pc, mask, "fused_encoder_pool_int8")
    if packed.data.device != pc.device:
        raise ValueError("weights must lie on the input's device")
    bsz, n, _ = pc.shape
    bits = torch.empty((bsz, packed.c_last), dtype=torch.int32,
                       device=pc.device)
    out = torch.empty((bsz, packed.c_last), dtype=torch.float32,
                      device=pc.device)
    index = pc.device.index
    lib = _int8_lib(packed.instance)
    args = (pc.data_ptr(), mask.data_ptr() if mask is not None else None,
            packed.data.data_ptr(), ctypes.addressof(packed.c_dims),
            len(packed.dims) - 1, packed.c_last, bsz, n)
    tail = (bits.data_ptr(), out.data_ptr(), _cuda.stream_of(pc))
    with torch.cuda.device(pc.device):
        if packed.instance == "wide":
            err = lib.grl_encoder_pool_int8_wide(*args, index, *tail)
        else:
            err = lib.grl_encoder_pool_int8(*args, _sm_count(pc.device),
                                            index, *tail)
    name = ("encoder_pool_int8" if packed.instance == "mma"
            else "encoder_pool_int8_wide")
    _cuda.check(err, lib, name)
    _cuda.launch_counts[name] += 1
    return out


def fused_encoder_pool_int8(pc: Tensor, qenc: dict,
                            mask: Optional[Tensor] = None) -> Tensor:
    """pc (B, N, 3)[, mask (B, N)] -> pooled features (B, C_last) f32
    through the int8 bundle ``qenc``.

    K6 on a CUDA tensor, the instance ``int8_instance`` picks with the
    bundle packed once (``packed_int8_encoder``); the plain version on a
    CPU tensor (encoder_kernel.py:204-258)."""
    if pc.device.type == "cpu":
        return fused_encoder_pool_int8_plain(pc, qenc, mask)
    w0, b0 = qenc["layer0"]
    _cuda.refuse_grad("fused_encoder_pool_int8", "K6 serves the int8 "
                      "inference engine", pc, w0, b0)
    return encoder_pool_int8_packed(pc, packed_int8_encoder(qenc), mask)


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
