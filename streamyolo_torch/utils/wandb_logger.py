"""The Weights & Biases sink, the port's own copy of
``streamyolo_tpu/utils/wandb_logger.py``: metric logging, per-epoch val
metrics and the checkpoint artifact. Without the ``wandb`` package every
call is a no-op (one warning at construction), so a run that asks for the
sink (``tools/train.py -l wandb``) still trains. ``wandb-<key> <value>``
pairs among the CLI's ``opts`` become ``wandb.init`` arguments."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from streamyolo_torch.utils.logger import get_logger


class WandbLogger:
    def __init__(self, project: Optional[str] = None, name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None, **kwargs):
        self._run = None
        try:
            import wandb
        except ImportError:
            self._wandb = None
            get_logger().warning("wandb is not installed; WandbLogger degrades to a no-op sink")
            return
        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, config=config, **kwargs)

    @classmethod
    def initialize_wandb_logger(cls, args, exp, val_dataset=None):
        prefix = "wandb-"
        opts = getattr(args, "opts", None) or []
        params = {k[len(prefix):]: v for k, v in zip(opts[0::2], opts[1::2])
                  if k.startswith(prefix)}
        return cls(config=vars(exp) if hasattr(exp, "__dict__") else None, **params)

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if self._run is not None:
            self._wandb.log(metrics, step=step)

    def save_checkpoint(self, save_dir: str, model_name: str, is_best: bool, metadata=None):
        """Upload ``<save_dir>/<model_name>_ckpt.pth`` as a model artifact."""
        if self._run is not None:
            artifact = self._wandb.Artifact(model_name, type="model", metadata=metadata)
            artifact.add_file(os.path.join(save_dir, model_name + "_ckpt.pth"))
            self._run.log_artifact(artifact, aliases=["best"] if is_best else None)

    def finish(self):
        if self._run is not None:
            self._run.finish()
