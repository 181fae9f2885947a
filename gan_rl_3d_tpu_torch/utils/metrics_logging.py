"""Scalar metrics logging (gan_rl_3d_tpu/utils/metrics_logging.py): a JSONL
file always, TensorBoard and wandb when installed.

``metrics.jsonl`` under the log directory gets one line per scalar,
``{"tag", "value", "step", "time"}``, with the JAX trainer's tags (AE/*,
GAN/*, RL/*, Joint/*), so one reader takes either package's runs.
``logging.use_tensorboard`` writes the same scalars through
``torch.utils.tensorboard`` and ``logging.use_wandb`` to a wandb run named
by ``logging.project_name``; where the package is missing the logger
warns once and keeps the JSONL file, as the JAX logger does.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

from gan_rl_3d_tpu_torch.parallel.mesh import is_writer

log = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, log_dir: str, *, use_tensorboard: bool = False,
                 use_wandb: bool = False, project_name: str = "RL-GAN-Net",
                 filename: str = "metrics.jsonl"):
        self.log_dir = Path(log_dir)
        self._tb = None
        self._wandb = None
        # under torch.distributed only rank 0 writes
        self._file = None
        if not is_writer():
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / filename, "a", buffering=1)
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=str(self.log_dir))
            except ImportError:
                log.warning("logging.use_tensorboard=true but tensorboard "
                            "is not installed; falling back to JSONL only")
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project_name,
                                         dir=str(self.log_dir))
            except ImportError:
                log.warning("logging.use_wandb=true but wandb is not "
                            "installed; falling back to JSONL/TensorBoard")

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self._file is None:
            return
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._file.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        if self._wandb is not None:
            self._wandb.log({tag: float(value)}, step=int(step))

    def log_dict(self, prefix: str, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            self.log_scalar(f"{prefix}/{k}", float(v), step)

    def close(self) -> None:
        if self._file is None or self._file.closed:
            return
        self._file.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
