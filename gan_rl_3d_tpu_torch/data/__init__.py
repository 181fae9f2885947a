"""Data layer (gan_rl_3d_tpu/data): point-cloud datasets, their batch
plans and the synthetic generator. The host reads files and batches
complete clouds; hole cutting, augmentation and normalisation run on the
device inside the training steps (gan_rl_3d_tpu_torch.ops.pointcloud)."""

from gan_rl_3d_tpu_torch.data.dataset import (  # noqa: F401
    ShapeNetDataset,
    create_dataloader,
    setup_dataset,
)
from gan_rl_3d_tpu_torch.data.synthetic import (  # noqa: F401
    create_synthetic_dataset,
    generate_synthetic_cloud,
)
