"""Set up the dataset (the port of the root ``setup_dataset.py``).

  python -m gan_rl_3d_tpu_torch.setup_dataset [--data-dir DIR] \
      [--synthetic] [--samples-per-category N] [--test]

``--synthetic`` writes the generated set (the JAX package's files, byte for
byte); without it the instructions for the real ShapeNet download are
printed. ``--test`` loads the train and test splits through
``create_dataloader`` and prints a batch's keys and shape.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from gan_rl_3d_tpu_torch.data import create_dataloader, setup_dataset


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Setup RL-GAN-Net dataset")
    parser.add_argument("--data-dir", type=str, default="./data/shapenet")
    parser.add_argument("--synthetic", action="store_true",
                        help="Create synthetic dataset for testing")
    parser.add_argument("--samples-per-category", type=int, default=100)
    parser.add_argument("--test", action="store_true",
                        help="Test data loading after setup")
    args = parser.parse_args(argv)

    print(f"Setting up dataset at {args.data_dir} "
          f"(synthetic={args.synthetic})")
    setup_dataset(args.data_dir, synthetic=args.synthetic,
                  samples_per_category=args.samples_per_category)

    if args.test:
        loader = create_dataloader(args.data_dir, split="train", batch_size=4)
        print(f"Train dataset size: {len(loader.dataset)}")
        batch = next(iter(loader))
        print(f"Batch keys: {list(batch.keys())}")
        print(f"Complete point cloud shape: {batch['complete_pc'].shape}")
        val = create_dataloader(args.data_dir, split="test", batch_size=4)
        print(f"Validation dataset size: {len(val.dataset)}")
        print("Data loading test passed")

    print(f"Dataset location: {Path(args.data_dir).absolute()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
