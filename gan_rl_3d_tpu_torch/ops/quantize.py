"""Post-training int8 quantization of the encoder for the deployment engine
(gan_rl_3d_tpu/ops/quantize.py).

Scheme:
* weights: per-output-channel symmetric int8, ``s_w[c] = max_k |w[k,c]|/127``
  (clamped at 1e-12);
* activations: dynamic per-row (per-point) symmetric scales,
  ``s_x[r] = max_c |x[r,c]|/127``, computed right before each product, so
  the bundle needs no calibration pass;
* products: int8 x int8 summed exactly, dequantized with the rank-1 factor
  ``s_x[r] * s_w[c]`` and rebiased in f32.

``torch.round`` rounds half to even, as ``jnp.round`` does. Every divide
is an IEEE division on every device (``div127``). The int8
products are computed as an f32 matmul of integer-valued operands: every
partial sum is an integer of magnitude at most K * 127**2 (4,129,024 at
K=256), below 2**24, so the f32 sum is exact in any order and equals the
int32 one. It runs on the CPU and on the card alike (cuBLAS has no int32
product).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

Tensor = torch.Tensor


def div127(x: Tensor) -> Tensor:
    """x / 127, an IEEE division on every device: divided by a Python
    number, PyTorch's CUDA kernel multiplies by the reciprocal instead,
    which differs in the last bit for about one value in twenty."""
    return x / torch.full((), 127.0, device=x.device)


def quantize_weight_per_channel(w: Tensor) -> Tuple[Tensor, Tensor]:
    """(K, C) f32 -> (int8 (K, C), f32 scale (1, C)); the scale is clamped
    after the divide (quantize.py:42-48)."""
    s = torch.clamp(div127(w.abs().amax(dim=0, keepdim=True)), min=1e-12)
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq, s


def quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(R, K) f32 -> (int8 (R, K), f32 per-row scale (R, 1)); the scale is
    clamped after the divide (quantize.py:51-56)."""
    s = torch.clamp(div127(x.abs().amax(dim=1, keepdim=True)), min=1e-12)
    xq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return xq, s


def int8_matmul(xq: Tensor, wq: Tensor) -> Tensor:
    """The exact integer product of int8-valued operands, as f32."""
    return torch.matmul(xq.float(), wq.float())


def int8_dense(xq: Tensor, s_x: Tensor, wq: Tensor, s_w: Tensor,
               bias: Tensor) -> Tensor:
    """int8 x int8 product, dequantized as ``(acc * s_x) * s_w + bias``
    (quantize.py:59-66)."""
    return int8_matmul(xq, wq) * s_x * s_w + bias


def quantize_encoder(folded_layers: List[Tuple[Tensor, Tensor]]) -> dict:
    """The quantized encoder bundle from BN-folded (w, b) layers
    (quantize.py:69-89)::

        {"layer0": (w f32 (3, C0), b f32 (1, C0)),
         "layers_q": [(wq int8 (K, C), s_w f32 (1, C), b f32 (1, C)), ...]}
    """
    w0, b0 = folded_layers[0]
    layers_q = []
    for w, bias in folded_layers[1:]:
        wq, s_w = quantize_weight_per_channel(w.float())
        layers_q.append((wq, s_w, bias.float().reshape(1, -1)))
    return {"layer0": (w0.float(), b0.float().reshape(1, -1)),
            "layers_q": layers_q}


def encode_int8_plain(pc: Tensor, qenc: dict,
                      mask: Optional[Tensor] = None) -> Tensor:
    """Quantized point-MLP + masked max-pool through ``quantize_rows`` and
    ``int8_dense``, the counterpart of ``encode_int8_xla``
    (quantize.py:92-115). (B, N, 3) -> (B, C_last) f32."""
    b, n, _ = pc.shape
    x = pc.reshape(b * n, 3).float()
    w0, b0 = qenc["layer0"]
    y = torch.relu((x[:, 0:1] * w0[0:1, :] + x[:, 1:2] * w0[1:2, :]
                    + x[:, 2:3] * w0[2:3, :]) + b0)
    for wq, s_w, bias in qenc["layers_q"]:
        xq, s_x = quantize_rows(y)
        y = torch.relu(int8_dense(xq, s_x, wq, s_w, bias))
    y = y.reshape(b, n, -1)
    if mask is not None:
        y = torch.where(mask[..., None] > 0, y,
                        torch.tensor(float("-inf"), device=y.device))
    return y.amax(dim=1)
