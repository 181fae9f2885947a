"""PCN, the Point Completion Network (Yuan, Khot, Held, Mertz, Hebert,
3DV 2018, arXiv:1808.00671), as its ``models/pcn_cd.py`` writes it: no
BatchNorm anywhere, every layer a shared dense layer with a ReLU on all
but the last of a stack.

* ``pcn_encoder_*``: stage 0 maps each point 3 -> 128 -> 256 and max-pools
  the cloud into g0; stage 1 maps ``[f, g0]`` (512 wide, g0 on every row)
  512 -> 1024 and max-pools again: the GFV ``v`` (B, 1024). Both pools
  leave out the rows the mask marks as padding.
* ``folding_decoder_*``: a coarse MLP 1024 -> 1024 -> 1024 -> 3 C, reshaped
  to C coarse points; then fine point ``k = S c + j`` of each coarse point
  ``c`` and grid point ``j`` takes ``[grid[j], coarse[c], v]`` (1,029 wide)
  through 512 -> 512 -> 3 and adds ``coarse[c]``: C S fine points. The
  grid is ``meshgrid(linspace(-scale, scale, s), same)`` in TF's ``xy``
  order, ``grid[i s + j] = (t[j], t[i])``, kept in the decoder's state.

The folding's first layer is the published dense layer over
``[grid[j], coarse[c], v]``, computed from the products its rows share
(``_folding_hidden``): the grid's once a call, the GFV's once a cloud,
the coarse point's once, and their broadcast sum; the 1,029-wide input is
never built. The decoder's forward folding runs in the span
``ae.folding``. Weights are Glorot-uniform with zero biases (the defaults
of the tf.contrib layers PCN uses), drawn from ``generator`` in the order
encoder stage 0, stage 1, coarse MLP, folding MLP, each layer's weight.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gan_rl_3d_tpu_torch import nn
from gan_rl_3d_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

ENCODER_DIMS = (128, 256, 512, 1024)
COARSE_DIMS = (1024, 1024, 3072)
FOLDING_DIMS = (512, 512)


def _mlp_init(generator: torch.Generator, d_in: int, dims: Sequence[int]
              ) -> list:
    layers = []
    for d_out in dims:
        layers.append(nn.dense_init(generator, d_in, d_out,
                                    w_init=nn.xavier_uniform, bias_const=0.0))
        d_in = d_out
    return layers


def _mlp(layers: list, x: Tensor) -> Tensor:
    """Dense layers with a ReLU after each but the last (``mlp`` and
    ``mlp_conv`` of PCN's tf_util)."""
    for i, p in enumerate(layers):
        x = nn.dense(p, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _pool(x: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Max over the rows the mask keeps (every row without a mask)."""
    if mask is not None:
        x = torch.where(mask[..., None] > 0, x,
                        torch.tensor(float("-inf"), dtype=x.dtype,
                                     device=x.device))
    return x.amax(dim=-2)


def pcn_encoder_init(generator: torch.Generator, input_dim: int = 3,
                     latent_dim: int = 1024,
                     hidden_dims: Sequence[int] = ENCODER_DIMS
                     ) -> Tuple[dict, dict]:
    """Stage 0 ``hidden_dims[:2]``, stage 1 ``hidden_dims[2:]`` over the
    concatenation of stage 0's features and their pool; no state."""
    if len(hidden_dims) != 4 or hidden_dims[-1] != latent_dim:
        raise ValueError(f"the PCN encoder takes four widths ending in "
                         f"latent_dim={latent_dim}, got {tuple(hidden_dims)}")
    stage0 = _mlp_init(generator, input_dim, hidden_dims[:2])
    stage1 = _mlp_init(generator, 2 * hidden_dims[1], hidden_dims[2:])
    return {"stage0": stage0, "stage1": stage1}, {}


def pcn_encoder_apply(params: dict, state: dict, pc: Tensor,
                      mask: Optional[Tensor] = None) -> Tuple[Tensor, dict]:
    """pc (B, N, 3)[, mask (B, N)] -> (GFV (B, latent_dim), state)."""
    f = _mlp(params["stage0"], pc)
    g0 = _pool(f, mask)
    h = _mlp(params["stage1"], torch.cat([f, g0[:, None].expand_as(f)], -1))
    return _pool(h, mask), state


def folding_grid(grid_size: int, grid_scale: float) -> Tensor:
    """(grid_size^2, 2) float32: row ``i s + j`` is ``(t[j], t[i])`` for
    ``t = linspace(-grid_scale, grid_scale, grid_size)``."""
    t = torch.linspace(-grid_scale, grid_scale, grid_size)
    y, x = torch.meshgrid(t, t, indexing="ij")
    return torch.stack([x, y], -1).reshape(-1, 2)


def folding_decoder_init(generator: torch.Generator, latent_dim: int = 1024,
                         num_coarse: int = 1024, grid_size: int = 4,
                         grid_scale: float = 0.05,
                         hidden_dims: Sequence[int] = COARSE_DIMS
                         ) -> Tuple[dict, dict]:
    """The coarse MLP ``hidden_dims`` (the last = 3 ``num_coarse``) and the
    folding MLP, PCN's 512 -> 512 -> 3; the state holds the grid."""
    if hidden_dims[-1] != 3 * num_coarse:
        raise ValueError(f"last coarse width must be 3 num_coarse="
                         f"{3 * num_coarse}, got {hidden_dims[-1]}")
    coarse = _mlp_init(generator, latent_dim, hidden_dims)
    folding = _mlp_init(generator, 2 + 3 + latent_dim,
                        FOLDING_DIMS + (3,))
    return ({"coarse": coarse, "folding": folding},
            {"grid": folding_grid(grid_size, grid_scale)})


def _folding_hidden(p: dict, grid: Tensor, coarse: Tensor, gfv: Tensor
                    ) -> Tensor:
    """The folding's first layer and its ReLU, (B, C S, width): fine row
    ``k = S c + j`` takes ``[grid[j], coarse[c], v] W + b``, summed from
    ``grid W[:2]`` (once a call) and ``coarse W[2:5] + (v W[5:] + b)``
    (v's product once a cloud, the sum once a coarse point). That sum runs
    in f64 and is rounded once, so a row's value carries two roundings
    where the published layer's 1,029-term f32 product carries many, and
    the ReLUs downstream switch where the published layer's do, up to its
    own rounding. The result follows the weight's dtype, as
    ``nn.dense``'s does."""
    w = p["w"]
    acc = torch.promote_types(w.dtype, torch.float32)
    w64 = w.double()
    per_coarse = (coarse.double() @ w64[2:5]
                  + (gfv.double() @ w64[5:] + p["b"].double())[:, None])
    h = per_coarse.to(acc)[:, :, None] + grid.to(acc) @ w[:2].to(acc)
    return torch.relu(h.flatten(1, 2).to(w.dtype))


def folding_decoder_outputs(params: dict, state: dict, gfv: Tensor
                            ) -> Tuple[Tensor, Tensor]:
    """GFV (B, latent) -> (coarse (B, C, 3), fine (B, C S, 3))."""
    bsz = gfv.shape[0]
    coarse = _mlp(params["coarse"], gfv).reshape(bsz, -1, 3)
    with span("ae.folding"):
        grid = state["grid"].to(gfv.dtype)
        h = _folding_hidden(params["folding"][0], grid, coarse, gfv)
        fine = _mlp(params["folding"][1:], h) \
            + coarse.repeat_interleave(grid.shape[0], dim=1)
    return coarse, fine


def folding_decoder_apply(params: dict, state: dict, gfv: Tensor
                          ) -> Tuple[Tensor, dict]:
    """(the fine cloud, state), as the other decoders return theirs."""
    return folding_decoder_outputs(params, state, gfv)[1], state


def is_folding(decoder_params: dict) -> bool:
    return "folding" in decoder_params


def is_pcn_encoder(encoder_params: dict) -> bool:
    return "stage1" in encoder_params
