"""Typed configuration (gan_rl_3d_tpu/config.py).

Frozen dataclasses for ``model.*``, the training fields the serving path,
``evaluate`` and the autoencoder phase read, ``loss``, ``data``,
``evaluation`` and ``logging``, with the JAX package's defaults and validation
(gan_rl_3d_tpu/config.py:29-311). ``load_config`` reads the same YAML
schema; sections and keys the port does not model yet (the LGAN, RL and
joint training blocks but the exploration noise) are skipped.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from gan_rl_3d_tpu_torch.models.rl_agent import TD3Config
from gan_rl_3d_tpu_torch.ops.pointcloud import PreprocSpec

GATE_MODES = ("discriminator", "rl", "ae", "union")


@dataclass(frozen=True)
class AutoencoderModelConfig:
    input_dim: int = 3
    latent_dim: int = 128
    num_points: int = 2048
    encoder_dims: Tuple[int, ...] = (64, 128, 128, 256, 128)
    decoder_dims: Tuple[int, ...] = (256, 256, 6144)
    encoder_type: str = "pointnet"
    decoder_type: str = "mlp"


@dataclass(frozen=True)
class LGANModelConfig:
    z_dim: int = 1
    latent_dim: int = 128
    generator_dims: Tuple[int, ...] = (256, 512, 512, 256, 128)
    discriminator_dims: Tuple[int, ...] = (128, 256, 512, 256, 1)
    spectral_norm: bool = True


@dataclass(frozen=True)
class RLAgentModelConfig:
    state_dim: int = 128
    action_dim: int = 1
    hidden_dims: Tuple[int, ...] = (400, 400, 300, 300)


@dataclass(frozen=True)
class AETrainConfig:
    epochs: int = 100
    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 1e-5
    scheduler_step: int = 30
    scheduler_gamma: float = 0.1
    # "step": torch StepLR semantics; "cosine": cosine decay over the phase
    lr_schedule: str = "step"
    # stage s of 3 trains with the hole bounds scaled by (s + 1) / 3
    hole_curriculum: bool = False

    def __post_init__(self):
        if self.lr_schedule not in ("step", "cosine"):
            raise ValueError(
                f"autoencoder.lr_schedule must be 'step' or 'cosine', "
                f"got {self.lr_schedule!r}")


@dataclass(frozen=True)
class RLTrainConfig:
    exploration_noise: float = 0.1


@dataclass(frozen=True)
class TrainingConfig:
    # "float32"; "bfloat16"/"bf16" (bf16 matmul operands and activations,
    # f32 master weights, BN statistics and loss); "bf16_selective" (bf16
    # but the decoder's coordinate head and the encoder's last point-MLP
    # layer, which stay f32)
    precision: str = "float32"
    # training BatchNorm statistics: "single_read_grouped" or "centered"
    bn_stats: str = "single_read_grouped"
    # the JAX package's placement of the resident train split on a mesh;
    # the port runs on one device, where both values place it whole
    data_residency: str = "replicated"
    seed: int = 42
    batch_size: int = 32
    num_workers: int = 4
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    results_dir: str = "./results"
    autoencoder: AETrainConfig = field(default_factory=AETrainConfig)
    rl_agent: RLTrainConfig = field(default_factory=RLTrainConfig)

    def __post_init__(self):
        if self.precision not in ("float32", "f32", "bfloat16", "bf16",
                                  "bf16_selective"):
            raise ValueError(
                f"training.precision must be one of float32/bfloat16/"
                f"bf16_selective, got {self.precision!r}")
        if self.bn_stats not in ("centered", "single_read_grouped"):
            raise ValueError(
                f"training.bn_stats must be 'centered' or "
                f"'single_read_grouped', got {self.bn_stats!r}")
        if self.data_residency not in ("replicated", "sharded"):
            raise ValueError(
                f"training.data_residency must be 'replicated' or "
                f"'sharded', got {self.data_residency!r}")


@dataclass(frozen=True)
class LossConfig:
    chamfer_loss: str = "bidirectional"
    reconstruction_loss: str = "chamfer"

    def __post_init__(self):
        if self.chamfer_loss not in ("bidirectional", "forward",
                                     "unidirectional"):
            raise ValueError(
                f"loss.chamfer_loss must be 'bidirectional' or 'forward', "
                f"got {self.chamfer_loss!r}")
        if self.reconstruction_loss not in ("chamfer", "mse"):
            raise ValueError(
                f"loss.reconstruction_loss must be 'chamfer' or 'mse', "
                f"got {self.reconstruction_loss!r}")

    @property
    def bidirectional(self) -> bool:
        return self.chamfer_loss == "bidirectional"


@dataclass(frozen=True)
class AugmentationConfig:
    rotation: bool = True
    jitter: bool = True
    scale: bool = True


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "./data/shapenet"
    train_split: float = 0.8
    val_split: float = 0.1
    test_split: float = 0.1
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    normalize: bool = True
    center: bool = True
    unit_sphere: bool = True
    hole_min_ratio: float = 0.2
    hole_max_ratio: float = 0.5


@dataclass(frozen=True)
class EvaluationConfig:
    metrics: Tuple[str, ...] = ("chamfer_distance", "completion_ratio",
                                "hausdorff_distance")
    save_visualizations: bool = True
    eval_frequency: int = 10
    fscore_threshold: float = 0.01
    # reported beside the primary threshold (config.py:296-301)
    fscore_thresholds: Tuple[float, ...] = (0.01, 0.02, 0.05)
    completion_threshold: float = 0.03


@dataclass(frozen=True)
class LoggingConfig:
    log_frequency: int = 100
    save_model_frequency: int = 10


@dataclass(frozen=True)
class ModelConfig:
    autoencoder: AutoencoderModelConfig = field(
        default_factory=AutoencoderModelConfig)
    lgan: LGANModelConfig = field(default_factory=LGANModelConfig)
    rl_agent: RLAgentModelConfig = field(default_factory=RLAgentModelConfig)
    gate_mode: str = "discriminator"
    gate_bias: float = 0.0

    def __post_init__(self):
        if self.gate_mode not in GATE_MODES:
            raise ValueError(
                f"model.gate_mode must be 'discriminator', 'rl', 'ae' or "
                f"'union', got {self.gate_mode!r}")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    def td3_config(self) -> TD3Config:
        return TD3Config(
            exploration_noise=self.training.rl_agent.exploration_noise)

    def preproc_spec(self) -> PreprocSpec:
        """data.{augmentation.*, normalize, center, unit_sphere,
        hole_*_ratio} as one PreprocSpec (config.py:382-397)."""
        d = self.data
        return PreprocSpec(
            rotation=d.augmentation.rotation, jitter=d.augmentation.jitter,
            scale=d.augmentation.scale, normalize=d.normalize,
            center=d.center, unit_sphere=d.unit_sphere,
            hole_min=d.hole_min_ratio, hole_max=d.hole_max_ratio)


def flagship_config() -> Config:
    """The shipped recipe (configs/config.yaml), as far as the port models
    it, without reading YAML: the default widths with an 8-d latent action
    space (z_dim = action_dim = 8), bf16_selective training at batch 64,
    the 200-epoch cosine autoencoder phase, and all five evaluation
    metrics."""
    return Config(
        model=ModelConfig(lgan=LGANModelConfig(z_dim=8),
                          rl_agent=RLAgentModelConfig(action_dim=8)),
        training=TrainingConfig(
            precision="bf16_selective", seed=42, batch_size=64,
            num_workers=4, checkpoint_dir="./checkpoints", log_dir="./logs",
            autoencoder=AETrainConfig(
                epochs=200, lr_schedule="cosine", batch_size=64, lr=1e-3,
                weight_decay=1e-5, scheduler_step=20, scheduler_gamma=0.5)),
        evaluation=EvaluationConfig(metrics=(
            "chamfer_distance", "completion_ratio", "hausdorff_distance",
            "f_score", "emd")),
        logging=LoggingConfig(log_frequency=100, save_model_frequency=20))


_TUPLE_FIELDS = {"encoder_dims", "decoder_dims", "generator_dims",
                 "discriminator_dims", "hidden_dims", "metrics",
                 "fscore_thresholds"}


def _build(cls, raw: Optional[Dict[str, Any]]):
    """Build a dataclass from a raw YAML dict, coercing numeric strings
    (YAML reads '1e-4' as a string) and skipping keys it does not model."""
    if raw is None:
        return cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        value = raw[f.name]
        sub_cls = globals().get(f.type) if isinstance(f.type, str) else f.type
        if f.name in _TUPLE_FIELDS:
            kwargs[f.name] = (tuple(value) if isinstance(value, (list, tuple))
                              else (value,))
        elif dataclasses.is_dataclass(sub_cls):
            kwargs[f.name] = _build(sub_cls, value)
        elif f.type in (float, "float"):
            kwargs[f.name] = float(value)
        elif f.type in (bool, "bool"):
            kwargs[f.name] = bool(value)
        elif f.type in (int, "int"):
            kwargs[f.name] = int(value)
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


def load_config(path: Optional[str] = None) -> Config:
    """Load a gan_rl_3d_tpu YAML config (the reference schema). A ``.json``
    file, which is YAML too, is read with the json module, so a config
    written as JSON loads where PyYAML is not installed."""
    raw: Dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            if str(path).endswith(".json"):
                raw = json.load(f)
            else:
                import yaml

                raw = yaml.safe_load(f) or {}
    c = _build(Config, raw)
    if c.model.rl_agent.action_dim != c.model.lgan.z_dim:
        raise ValueError(
            f"model.rl_agent.action_dim ({c.model.rl_agent.action_dim}) "
            f"must equal model.lgan.z_dim ({c.model.lgan.z_dim}); set both "
            "when changing the latent action space")
    return c
