"""Typed configuration (gan_rl_3d_tpu/config.py).

Frozen dataclasses for ``model.*``, the training fields of the serving
path, ``evaluate`` and phases 1-5 (autoencoder, LGAN, RL, joint fine-tune
with the D refresh and the gate calibration), ``loss``, ``data``,
``evaluation`` and ``logging``, with the JAX package's defaults and
validation (gan_rl_3d_tpu/config.py:29-311). ``load_config`` reads the
same YAML schema and, as the JAX package does, logs and skips a key it
does not know; keys only the JAX package reads are skipped in silence.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from gan_rl_3d_tpu_torch.models.rl_agent import TD3Config
from gan_rl_3d_tpu_torch.ops.pointcloud import PreprocSpec

GATE_MODES = ("discriminator", "rl", "ae", "union")
log = logging.getLogger(__name__)


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
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    tau: float = 0.005
    gamma: float = 0.99
    buffer_size: int = 100000
    batch_size: int = 64


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
class LGANTrainConfig:
    epochs: int = 200
    batch_size: int = 50
    generator_lr: float = 1e-4
    discriminator_lr: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.9
    lambda_gp: float = 10.0
    d_steps: int = 5


@dataclass(frozen=True)
class RLTrainConfig:
    episodes: int = 1000
    max_steps_per_episode: int = 10
    exploration_noise: float = 0.1
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    # actor updates skipped for the first N TD3 updates
    # (models.rl_agent.TD3Config.actor_warmup)
    actor_warmup: int = 0
    # then the actor lr ramps to actor_lr over this many applied policy
    # updates (TD3Config.actor_lr_ramp; 0 = constant lr)
    actor_lr_ramp: int = 0
    start_training_steps: int = 1000
    # parallel environments per iteration, env steps per episode (capped
    # by max_steps_per_episode), TD3 updates per iteration
    envs_per_step: int = 32
    steps_per_episode: int = 1
    updates_per_step: int = 1


@dataclass(frozen=True)
class JointTrainConfig:
    """Phase 5 and phase 5.5 (config.py:126-170)."""

    enabled: bool = True
    epochs: int = 50
    lr: float = 1e-4
    weight_decay: float = 1e-5
    # adds w * Chamfer(decode(noisy GFV), complete) to the joint loss, so
    # the AE path keeps training (0 = the reference's joint loss)
    w_ae_recon: float = 0.0
    # > 0: retrain D for this many WGAN-GP steps on the post-joint GFVs
    refresh_d_steps: int = 0
    # sweep the gate threshold on the val split and write
    # gate_calibration.json beside the checkpoints
    calibrate_gate: bool = False
    # G out of the trainable set, its forward in eval mode
    freeze_generator: bool = False
    # serve the GAN branch from a snapshot of (G, decoder) taken before
    # the joint phase; the D refresh draws its fakes from it
    preserve_gan_path: bool = False


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
    lgan: LGANTrainConfig = field(default_factory=LGANTrainConfig)
    rl_agent: RLTrainConfig = field(default_factory=RLTrainConfig)
    joint: JointTrainConfig = field(default_factory=JointTrainConfig)

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
    w_chamfer: float = 100.0
    w_gfv: float = 10.0
    w_discriminator: float = 0.01
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
    # metric backends beside the JSONL file (utils.metrics_logging); each
    # degrades to a warning where its package is not installed
    use_tensorboard: bool = True
    use_wandb: bool = False
    project_name: str = "RL-GAN-Net"
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
        """model.rl_agent + training.rl_agent as the TD3 step's config
        (config.py:356-380)."""
        m, t = self.model.rl_agent, self.training.rl_agent
        return TD3Config(
            state_dim=m.state_dim, action_dim=m.action_dim,
            actor_hidden=m.hidden_dims, critic_hidden=m.hidden_dims,
            actor_lr=m.actor_lr, critic_lr=m.critic_lr, gamma=m.gamma,
            tau=m.tau, batch_size=m.batch_size,
            exploration_noise=t.exploration_noise,
            policy_noise=t.policy_noise, noise_clip=t.noise_clip,
            policy_delay=t.policy_delay, actor_warmup=t.actor_warmup,
            actor_lr_ramp=t.actor_lr_ramp)

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
    the 200-epoch cosine autoencoder phase, the LGAN phase (10 epochs,
    batch 16, 3 D steps a G step), the RL phase (22,000 episodes over 64
    parallel environments, 64 TD3 updates an iteration, critic warmup and
    actor ramp), the joint phase (4 epochs at lr 1e-4 with the AE-path
    term, then 400 D refresh steps and the gate calibration), and all five
    evaluation metrics."""
    return Config(
        model=ModelConfig(lgan=LGANModelConfig(z_dim=8),
                          rl_agent=RLAgentModelConfig(action_dim=8)),
        training=TrainingConfig(
            precision="bf16_selective", seed=42, batch_size=64,
            num_workers=4, checkpoint_dir="./checkpoints", log_dir="./logs",
            autoencoder=AETrainConfig(
                epochs=200, lr_schedule="cosine", batch_size=64, lr=1e-3,
                weight_decay=1e-5, scheduler_step=20, scheduler_gamma=0.5),
            lgan=LGANTrainConfig(
                epochs=10, batch_size=16, generator_lr=1e-4,
                discriminator_lr=1e-4, beta1=0.5, beta2=0.9, lambda_gp=10.0,
                d_steps=3),
            rl_agent=RLTrainConfig(
                episodes=22000, max_steps_per_episode=5,
                exploration_noise=0.1, policy_noise=0.2, noise_clip=0.5,
                policy_delay=2, start_training_steps=256, envs_per_step=64,
                updates_per_step=64, actor_warmup=2000,
                actor_lr_ramp=1500),
            joint=JointTrainConfig(
                enabled=True, epochs=4, lr=1e-4, weight_decay=1e-5,
                w_ae_recon=1.0, refresh_d_steps=400, calibrate_gate=True,
                preserve_gan_path=False)),
        evaluation=EvaluationConfig(metrics=(
            "chamfer_distance", "completion_ratio", "hausdorff_distance",
            "f_score", "emd")),
        logging=LoggingConfig(use_tensorboard=False, use_wandb=False,
                              project_name="RL-GAN-Net-TPU",
                              log_frequency=100, save_model_frequency=20))


_TUPLE_FIELDS = {"encoder_dims", "decoder_dims", "generator_dims",
                 "discriminator_dims", "hidden_dims", "metrics",
                 "fscore_thresholds"}
# keys the JAX package reads and the port does not, skipped in silence as
# the reference's redundant ``paths`` block is: the JAX device string (the
# port's entry points take ``--device``)
_JAX_ONLY_KEYS = frozenset({"training.device"})


def _build(cls, raw: Optional[Dict[str, Any]], path: str = ""):
    """Build a dataclass from a raw YAML dict, coercing numeric strings
    (YAML reads '1e-4' as a string) and logging the keys it does not
    know (gan_rl_3d_tpu/config.py:404-415)."""
    if raw is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        if key not in fields:
            if key != "paths" and path + key not in _JAX_ONLY_KEYS:
                log.warning("config: ignoring unknown key %s%s", path, key)
            continue
        f = fields[key]
        sub_cls = globals().get(f.type) if isinstance(f.type, str) else f.type
        if key in _TUPLE_FIELDS:
            kwargs[key] = (tuple(value) if isinstance(value, (list, tuple))
                           else (value,))
        elif dataclasses.is_dataclass(sub_cls):
            kwargs[key] = _build(sub_cls, value, f"{path}{key}.")
        elif f.type in (float, "float"):
            kwargs[key] = float(value)
        elif f.type in (bool, "bool"):
            kwargs[key] = bool(value)
        elif f.type in (int, "int"):
            kwargs[key] = int(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a gan_rl_3d_tpu YAML config (the reference schema), with
    ``overrides`` (a nested dict of the same schema) merged over it key by
    key (config.py:434-448). A ``.json`` file, which is YAML too, is read
    with the json module, so a config written as JSON loads where PyYAML
    is not installed."""
    raw: Dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            if str(path).endswith(".json"):
                raw = json.load(f)
            else:
                import yaml

                raw = yaml.safe_load(f) or {}
    if overrides:
        raw = _deep_merge(raw, overrides)
    c = _build(Config, raw)
    if c.model.rl_agent.action_dim != c.model.lgan.z_dim:
        raise ValueError(
            f"model.rl_agent.action_dim ({c.model.rl_agent.action_dim}) "
            f"must equal model.lgan.z_dim ({c.model.lgan.z_dim}); set both "
            "when changing the latent action space")
    return c


def _deep_merge(base: Dict, extra: Dict) -> Dict:
    """``base`` with ``extra`` merged in: nested dicts merge, any other
    value replaces (config.py:454-461)."""
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
