"""Experiment (config) system: ``BaseExp`` and ``get_exp``, the counterparts
of ``streamyolo_tpu/exp/base.py``.

A config is a Python subclass that carries hyperparameter attributes and
factory methods, loaded by name or file (``get_exp``) and overridden from
the command line with ``exp.merge(opts)`` key/value pairs. The defaults are
the yolox base Exp's (e.g. ``test_conf=0.01`` and ``nmsthre=0.65``).

The repository's ``cfgs/*.py`` import the JAX package, so the port keeps its
own copies of the five shipped configs, under the same names, in
``streamyolo_torch/cfgs/``. ``get_exp`` matches a path into ``cfgs/`` by its
basename; any other existing file is loaded as a config module of its own.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import os
import sys
from typing import Optional, Sequence

SHIPPED_CONFIGS = (
    "l_s50_onex_dfp_tal_filp",
    "l_s50_still_dfp_flip",
    "l_s50_twox_dfp_tal_flip",
    "m_s50_onex_dfp_tal_flip",
    "s_s50_onex_dfp_tal_flip",
)
# the shipped ONE config of each model size
SIZE_CONFIGS = {"s": "s_s50_onex_dfp_tal_flip", "m": "m_s50_onex_dfp_tal_flip",
                "l": "l_s50_onex_dfp_tal_filp"}


class BaseExp:
    """Hyperparameter defaults (yolox base Exp values)."""

    def __init__(self):
        # ---------------- training ----------------
        self.seed: Optional[int] = None
        self.output_dir = "./StreamYOLO_outputs"
        self.print_interval = 10
        self.eval_interval = 10
        self.save_history_ckpt = True
        self.max_epoch = 300
        self.warmup_epochs = 5
        self.warmup_lr = 0.0
        self.min_lr_ratio = 0.05
        self.basic_lr_per_img = 0.01 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 15
        self.ema = True
        self.weight_decay = 5e-4
        self.momentum = 0.9
        # ---------------- data / augment ----------------
        self.data_num_workers = 4
        self.input_size = (640, 640)
        self.multiscale_range = 5
        self.random_size = None
        self.train_ann = "train.json"
        self.val_ann = "val.json"
        self.degrees = 10.0
        self.translate = 0.1
        self.mosaic_scale = (0.1, 2.0)
        self.mixup_scale = (0.5, 1.5)
        self.shear = 2.0
        self.enable_mixup = True
        self.mosaic_prob = 1.0
        self.mixup_prob = 1.0
        # ---------------- model ----------------
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        self.act = "silu"
        # ---------------- eval ----------------
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.65

    def merge(self, cfg_list: Sequence[str]):
        """Command-line ``key value`` override pairs; each value is parsed as
        a Python literal and cast to the type of the attribute it replaces."""
        cfg_list = list(cfg_list or [])
        if len(cfg_list) % 2:
            raise ValueError(f"override list must be key-value pairs, got {cfg_list}")
        for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if k.startswith("--"):
                k = k[2:]
            if not hasattr(self, k):
                raise AttributeError(f"{k} is not an attribute of {type(self).__name__}")
            src_value = getattr(self, k)
            try:
                value = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                value = v
            if src_value is not None and not isinstance(value, type(src_value)):
                try:
                    value = type(src_value)(value)
                except (ValueError, TypeError):
                    pass
            setattr(self, k, value)
        return self

    def __repr__(self):
        rows = [f"{k:25s}: {v}" for k, v in sorted(vars(self).items())
                if not k.startswith("_")]
        return "\n".join(rows)


def get_exp(exp_file: Optional[str] = None, exp_name: Optional[str] = None):
    """An ``Exp`` instance from a config file path or a shipped config name
    (``l_s50_onex_dfp_tal_filp``); the file wins when both are given."""
    if exp_file is None and exp_name is None:
        raise ValueError("please provide exp file or exp name")
    name = exp_name if exp_file is None else os.path.basename(exp_file).split(".")[0]
    if name in SHIPPED_CONFIGS:
        return importlib.import_module(f"streamyolo_torch.cfgs.{name}").Exp()
    if exp_file is None or not os.path.isfile(exp_file):
        raise ValueError(
            f"unknown config {exp_file or exp_name!r}: the port ships "
            f"{', '.join(SHIPPED_CONFIGS)}")
    exp_file = os.path.realpath(exp_file)
    spec = importlib.util.spec_from_file_location(name, exp_file)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module.Exp()
