"""Complete point clouds from files (the port of the root
``complete_clouds.py``).

Reads .txt/.pts/.ply/.h5 clouds, runs the completion on the card (or on
the CPU with ``--device cpu``), and writes PLYs in each input's own
coordinate frame (the unit-sphere normalisation is inverted on output).
The model is an exported engine (``--engine``, f32 or int8, through
``complete_fast``) or a training checkpoint (``--checkpoint NAME`` under
``training.checkpoint_dir``, through the unfolded ``complete``, with the
gate calibration sidecar only where it is scoped to that checkpoint).
Inputs go in fixed-size chunks, the last one padded to the same shape.
``--watch DIR`` keeps the model loaded and completes each new file that
appears in DIR.

  python -m gan_rl_3d_tpu_torch.complete_clouds --engine engine.pkl --output-dir out/ *.txt
  python -m gan_rl_3d_tpu_torch.complete_clouds --checkpoint joint_best --config configs/config.yaml *.ply
  python -m gan_rl_3d_tpu_torch.complete_clouds --engine engine.pkl --watch incoming/ --output-dir out/
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from gan_rl_3d_tpu_torch.config import flagship_config, load_config
from gan_rl_3d_tpu_torch.convert import model_from_numpy
from gan_rl_3d_tpu_torch.data.dataset import load_point_cloud, resample_with_mask
from gan_rl_3d_tpu_torch.device import resolve_device
from gan_rl_3d_tpu_torch.models import inference
from gan_rl_3d_tpu_torch.models import rl_gan_net as net
from gan_rl_3d_tpu_torch.train.gate import load_gate_calibration
from gan_rl_3d_tpu_torch.utils import ply
from gan_rl_3d_tpu_torch.utils.checkpoint import load_model_checkpoint

_CLOUD_SUFFIXES = (".txt", ".pts", ".ply", ".h5")


def _load_framed(path, n_points, rng):
    """Load one cloud, resample to n_points with a validity mask and
    normalise into the unit sphere; return (pc, mask, (centroid, scale))."""
    raw = load_point_cloud(path)
    if len(raw) == 0:
        raise ValueError("no points parsed")
    pc, mask = resample_with_mask(raw, n_points, rng)
    valid = pc[mask > 0]
    centroid = valid.mean(axis=0)
    scale = float(np.linalg.norm(valid - centroid, axis=1).max()) or 1.0
    return (pc - centroid) / scale, mask, (centroid, scale)


def _build_fn(args, config, device):
    """(clouds, masks) numpy -> the chosen output, as a numpy array."""
    gate_mode, gate_bias = load_gate_calibration(
        config.training.checkpoint_dir,
        # an engine's source checkpoint is unknown: a sidecar applies as is
        checkpoint=None if args.engine else args.checkpoint,
        default_mode=config.model.gate_mode,
        default_bias=config.model.gate_bias, verbose=True)
    if args.gate_mode is not None:
        gate_mode = args.gate_mode
        print(f"gate mode forced by --gate-mode: {gate_mode}")
    if args.engine:
        engine = inference.load_engine(args.engine, device=device)

        def run(pc, mask):
            return inference.complete_fast(engine, pc, mask,
                                           gate_mode=gate_mode,
                                           gate_bias=gate_bias)
    else:
        tree, _ = load_model_checkpoint(config.training.checkpoint_dir,
                                        args.checkpoint)
        model = model_from_numpy(tree, device=device)
        td3 = config.td3_config()

        def run(pc, mask):
            return net.complete(model, pc, mask, cfg=td3,
                                gate_mode=gate_mode, gate_bias=gate_bias)

    def fn(clouds: np.ndarray, masks: np.ndarray) -> np.ndarray:
        out = run(torch.from_numpy(clouds).to(device),
                  torch.from_numpy(masks).to(device))[args.output]
        return out.float().cpu().numpy()

    return fn


def _complete_and_write(fn, items, bs, out_dir):
    """items: list of (name, pc, mask, frame). Runs fixed-shape chunks
    (the last padded by repeating its final cloud), writes PLYs, returns
    the written paths."""
    written = []
    for start in range(0, len(items), bs):
        chunk = items[start:start + bs]
        clouds = [c[1] for c in chunk]
        masks = [c[2] for c in chunk]
        while len(clouds) < bs:
            clouds.append(clouds[-1])
            masks.append(masks[-1])
        result = fn(np.stack(clouds), np.stack(masks))
        for j, (name, _, _, (centroid, scale)) in enumerate(chunk):
            dest = Path(out_dir) / f"{name}_completed.ply"
            ply.save_ply(str(dest), result[j] * scale + centroid)
            written.append(dest)
    return written


def _watch(args, fn, n_points):
    """Poll --watch for new cloud files and complete each once per
    (name, mtime), once it is at least --settle seconds old. --max-files
    bounds the run; by default it runs until interrupted."""
    watch_dir = Path(args.watch)
    rng = np.random.RandomState(0)
    seen = {}
    done = 0
    print(f"watching {watch_dir}/ for {'/'.join(_CLOUD_SUFFIXES)} "
          f"-> {args.output_dir}/ (ctrl-c to stop)", flush=True)
    while args.max_files is None or done < args.max_files:
        batch = []
        now = time.time()
        present = set()
        for p in sorted(watch_dir.iterdir()) if watch_dir.is_dir() else []:
            if p.suffix.lower() not in _CLOUD_SUFFIXES:
                continue
            present.add(p.name)
            mtime = None
            try:
                mtime = p.stat().st_mtime
                if seen.get(p.name) == mtime or now - mtime < args.settle:
                    continue
                pc, mask, frame = _load_framed(str(p), n_points, rng)
            except OSError as e:
                if not p.exists():
                    continue
                print(f"{p}: skipped ({e})", flush=True)
                seen[p.name] = mtime if mtime is not None else now
                continue
            except ValueError as e:
                print(f"{p}: skipped ({e})", flush=True)
                seen[p.name] = mtime
                continue
            seen[p.name] = mtime
            batch.append((p.stem, pc, mask, frame))
            if args.max_files is not None and done + len(batch) >= args.max_files:
                break
        for name in list(seen):
            if name not in present:
                del seen[name]
        if batch:
            t0 = time.perf_counter()
            written = _complete_and_write(fn, batch, args.batch_size,
                                          args.output_dir)
            dt = time.perf_counter() - t0
            done += len(written)
            for w in written:
                print(f"-> {w}", flush=True)
            print(f"{len(written)} cloud(s) in {dt * 1e3:.1f} ms", flush=True)
        else:
            time.sleep(args.poll_interval)
    print(f"watch done: {done} cloud(s) completed", flush=True)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Complete point clouds")
    parser.add_argument("inputs", nargs="*", help="point-cloud files")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config (default: the flagship recipe)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint name under training.checkpoint_dir "
                             "(a pickle of either package)")
    parser.add_argument("--engine", type=str, default=None,
                        help="exported deployment engine (.pkl)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--output-dir", type=str, default="./completed")
    parser.add_argument("--gate-mode", type=str, default=None,
                        choices=["discriminator", "rl", "ae", "union"],
                        help="force a gate mode over config + calibration "
                             "sidecar; 'union' writes 2N points")
    parser.add_argument("--output", type=str, default="hybrid_output",
                        choices=["hybrid_output", "completed_pc",
                                 "ae_reconstruction"])
    parser.add_argument("--batch-size", type=int, default=None,
                        help="fixed chunk size; default 64, or 8 in --watch "
                             "mode")
    parser.add_argument("--watch", type=str, default=None,
                        help="poll this directory and complete new files as "
                             "they appear")
    parser.add_argument("--poll-interval", type=float, default=0.25)
    parser.add_argument("--settle", type=float, default=0.2,
                        help="watch mode: only pick up files whose mtime is "
                             "at least this old, seconds")
    parser.add_argument("--max-files", type=int, default=None,
                        help="watch mode: exit after this many files")
    return parser


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    if bool(args.checkpoint) == bool(args.engine):
        parser.error("pass --checkpoint NAME or --engine FILE (one of "
                     "them): serving a randomly initialized model would "
                     "silently produce garbage")
    if bool(args.inputs) == bool(args.watch):
        parser.error("pass input files OR --watch DIR")
    config = load_config(args.config) if args.config else flagship_config()
    if args.checkpoint:
        path = Path(config.training.checkpoint_dir) / args.checkpoint
        if not path.is_file():
            parser.error(f"no pickle checkpoint {path} (an orbax directory "
                         "needs the reader in ROADMAP.md queue 1, item 1)")
    device = resolve_device(args.device)

    n_points = config.model.autoencoder.num_points
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    fn = _build_fn(args, config, device)

    if args.watch:
        args.batch_size = 8 if args.batch_size is None \
            else max(1, args.batch_size)
        _watch(args, fn, n_points)
        return

    rng = np.random.RandomState(0)
    items = []
    for path in args.inputs:
        try:
            pc, mask, frame = _load_framed(path, n_points, rng)
        except (IOError, ValueError) as e:
            parser.error(f"{path}: cannot load ({e})")
        items.append((Path(path).stem, pc, mask, frame))

    bs = max(1, min(args.batch_size or 64, len(items)))
    t0 = time.perf_counter()
    written = _complete_and_write(fn, items, bs, args.output_dir)
    for src, dest in zip(args.inputs, written):
        print(f"{src} -> {dest}")
    print(f"completed {len(items)} clouds in "
          f"{time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
