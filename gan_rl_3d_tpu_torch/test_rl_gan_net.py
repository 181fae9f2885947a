"""Integration demo (the port of the root ``test_rl_gan_net.py``): builds
the model from the default config with the demo's rl_agent overrides, runs
each phase's forward, the full inference path, and a checkpoint save ->
load round trip into a model drawn from another seed, printing shapes.

  python -m gan_rl_3d_tpu_torch.test_rl_gan_net [--device cuda|cpu]

Exits non-zero if the restored model's completions differ from the saved
model's. (A CLI, not a test module: pytest collects only ``tests/``.)
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from gan_rl_3d_tpu_torch.config import load_config
from gan_rl_3d_tpu_torch.convert import model_from_numpy, model_to_numpy
from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.utils import checkpoint as ckpt
from gan_rl_3d_tpu_torch.utils.tree import tree_leaves


def _shape(x: torch.Tensor) -> tuple:
    return tuple(x.shape)


def _load_into(target: dict, loaded: dict) -> dict:
    """Copy the loaded serving weights into ``target``'s tensors, which
    must have their shapes (a restore into an existing model)."""
    with torch.no_grad():
        for part in (("ae",), ("lgan",), ("agent", "actor")):
            dst, src = target, loaded
            for k in part:
                dst, src = dst[k], src[k]
            for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
                if d.shape != s.shape:
                    raise ValueError(f"checkpoint {'/'.join(part)}: shape "
                                     f"{tuple(s.shape)}, model "
                                     f"{tuple(d.shape)}")
                d.copy_(s)
    return target


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="RL-GAN-Net integration "
                                                 "demo (PyTorch port)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    device = resolve_device(parser.parse_args(argv).device)
    config = load_config(None, overrides={
        "model": {"rl_agent": {"buffer_size": 10000, "batch_size": 32}},
    })
    td3 = config.td3_config()
    gen = torch.Generator().manual_seed(0)
    model = net.init_model(gen, config, device)
    print("RL-GAN-Net (PyTorch) integration test")
    print(f"devices: [{device}]")

    batch_size, num_points = 4, config.model.autoencoder.num_points
    pc = torch.randn((batch_size, num_points, 3), generator=gen).to(device)
    print(f"input shape: {_shape(pc)}")

    res = net.forward(model, pc, phase="autoencoder", mode="training")
    print(f"[autoencoder] noisy GFV {_shape(res['noisy_gfv'])}, "
          f"reconstruction {_shape(res['ae_reconstruction'])}")

    z = torch.randn((batch_size, config.model.lgan.z_dim),
                    generator=gen).to(device)
    res = net.forward(model, pc, phase="lgan", mode="training", z=z)
    print(f"[lgan] clean GFV {_shape(res['clean_gfv'])}, "
          f"completed {_shape(res['completed_pc'])}")

    res = net.forward(model, pc, phase="rl_agent", mode="training", cfg=td3)
    print(f"[rl_agent] z {_shape(res['z_vector'])}, "
          f"completed {_shape(res['completed_pc'])}")

    res = net.complete(model, pc, cfg=td3)
    print(f"[inference] hybrid output {_shape(res['hybrid_output'])}, "
          f"scores {_shape(res['rl_gan_score'])}")

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt"
        ckpt.save_checkpoint(path, {"model": model_to_numpy(model)})
        model2 = net.init_model(torch.Generator().manual_seed(99), config,
                                device)
        restored = _load_into(model2, model_from_numpy(
            ckpt.load_checkpoint(path)["model"], device=device))
        out1 = net.complete(model, pc, cfg=td3)["completed_pc"]
        out2 = net.complete(restored, pc, cfg=td3)["completed_pc"]
        if not torch.allclose(out1, out2):
            print("checkpoint round trip changed outputs")
            return 1
        print("[checkpoint] save -> load round trip OK")

    print("All integration checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
