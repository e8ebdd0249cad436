"""StreamYOLO experiment base (model and eval side), the counterpart of
``streamyolo_tpu/exp/stream_exp.py``.

The five shipped configs differ only in depth / width, the TAL
hyperparameters, and the dataset, evaluator and head classes, so those are
class attributes here and each ``streamyolo_torch/cfgs/*.py`` is a short
subclass.

The weights follow the JAX package's split between a module and its
variables: ``get_model(device)`` builds the module in the compute dtype on
the device, and ``init_model()`` gives the float32 state dict of the seeded
initialisation (the role of the JAX ``init_model``'s variables). A caller
merges a checkpoint into that state dict and folds BN into it in float32
(``utils/fuse.py``) before ``load_state_dict`` casts it once to the
module's dtype.

The train side: ``get_data_loader`` (the mosaic wrapper's non-mosaic branch
over the train split, the seeded infinite sampler), the LR schedule, the
``Trainer``, and multiscale training: ``random_resize`` draws a size per
10-step window from a NumPy ``RandomState`` seeded by (seed, window), and
``preprocess`` resizes a batch on its device with ``F.interpolate``
(bilinear, no antialiasing) and scales the cxcywh labels.

Under a process group of W > 1 ranks (``parallel/``), the train loader of
each rank yields ``batch // W`` images from the rank-strided sampler, and
the val loader reads the rank's strided shard (``ShardDataset``), whose
detections the evaluator gathers, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamyolo_torch.exp.base import BaseExp


class StreamExp(BaseExp):
    # class-level knobs overridden by the shipped configs
    head_name = "tal"  # 'tal' | 'pipe'
    dataset_name = "one"  # 'one' | 'two' | 'still'
    evaluator_name = "onex"  # 'onex' | 'twox' | 'still'
    tal_gamma = 1.0
    tal_ignore_thr = 0.5
    tal_ignore_value = 1.5

    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.50
        self.data_num_workers = 6
        self.num_classes = 8
        self.input_size = (600, 960)  # (h, w)
        self.random_size = (50, 70)
        self.test_size = (600, 960)
        self.basic_lr_per_img = 0.001 / 64.0
        self.warmup_epochs = 1
        self.max_epoch = 15
        self.no_aug_epochs = 15
        self.eval_interval = 1
        self.train_ann = "train.json"
        self.val_ann = "val.json"
        self.data_dir = os.environ.get("STREAMYOLO_DATADIR", "/data")
        self.output_dir = os.environ.get("STREAMYOLO_OUTDIR", "./StreamYOLO_outputs")
        self.exp_name = type(self).__module__.split(".")[-1]
        # compute dtype of the modules: "bfloat16" builds bf16 modules (the
        # card's mixed precision); BN statistics are folded or loaded from
        # float32 either way
        self.compute_dtype = "float32"

    # ---------------- model ----------------

    def _build(self) -> torch.nn.Module:
        from streamyolo_torch.models.dfp_pafpn import DFPPAFPN
        from streamyolo_torch.models.heads import PIPEHead, TALHead
        from streamyolo_torch.models.yolox import StreamYOLO

        in_channels = (256, 512, 1024)
        backbone = DFPPAFPN(self.depth, self.width, in_channels=in_channels, act=self.act)
        if self.head_name == "tal":
            head = TALHead(num_classes=self.num_classes, width=self.width,
                           in_channels=in_channels, act=self.act, gamma=self.tal_gamma,
                           ignore_thr=self.tal_ignore_thr, ignore_value=self.tal_ignore_value)
        else:
            head = PIPEHead(num_classes=self.num_classes, width=self.width,
                            in_channels=in_channels, act=self.act)
        return StreamYOLO(backbone=backbone, head=head)

    def get_model(self, device="cuda", dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
        """The model in eval mode on ``device``, its modules in the compute
        dtype (bf16 modules for ``compute_dtype='bfloat16'``, not only a bf16
        input) unless ``dtype`` is given (the trainer's float32 master
        weights), channels_last on a card. Load weights into it with
        ``load_state_dict`` (``init_model()`` for the seeded ones)."""
        from streamyolo_torch.utils.device import resolve_device

        dev = resolve_device(device)
        if dtype is None:
            dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        model = self._build().to(device=dev, dtype=dtype).eval()
        if dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model

    def init_model(self) -> Dict[str, torch.Tensor]:
        """The float32 CPU state dict of the seeded initialisation
        (``models/yolox.py::init_weights`` from ``seed``, 0 if unset)."""
        from streamyolo_torch.models.yolox import init_weights

        gen = torch.Generator().manual_seed(self.seed or 0)
        return init_weights(self._build(), gen).state_dict()

    def _check_dtype(self, model) -> None:
        from streamyolo_torch.stream.online import _warn_if_fp32_built

        _warn_if_fp32_built(model, self.compute_dtype == "bfloat16")

    def get_forward_fn(self, model, mode: str = "off_pipe") -> Callable[[np.ndarray], torch.Tensor]:
        """Eval forward: NHWC uint8 (or float) NumPy batch -> decoded
        ``[B, N, 5+C]`` on the model's device. On a card it runs with cuDNN
        off (``eval/seq_forward.py::per_image_convolution``), as the dedup
        forward does, so that both evals compute every image alike."""
        from streamyolo_torch.eval.seq_forward import per_image_convolution

        self._check_dtype(model)
        device = next(model.parameters()).device

        @torch.inference_mode()
        def forward(images: np.ndarray) -> torch.Tensor:
            x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            with per_image_convolution(device):
                return model(x, mode=mode)

        return forward

    def dedup_tolerance(self):
        """(box pixels, scores) of the dedup forward's first-batch guard: the
        JAX package's, (1e-4, 1e-4) for float32 and (1.0, 5e-3) for bf16
        modules."""
        return (1.0, 5e-3) if self.compute_dtype != "float32" else (1e-4, 1e-4)

    def get_dedup_forward_fn(self, model, dataset, verify_first_batch: bool = True):
        """Sequential-dedup eval forward (``eval/seq_forward.py``): one
        backbone pass per unique frame; needs a sequential, unsharded val
        traversal (ONE/TWO pairing, one process). ``verify_first_batch``
        (on by default: dedup is the default eval path) arms the first-batch
        guard against the dual-frame forward of the same model. On a card
        both run with cuDNN off (``SequentialDedupForward``)."""
        from streamyolo_torch.eval.seq_forward import SequentialDedupForward

        self._check_dtype(model)
        verify_fn = self.get_forward_fn(model) if verify_first_batch else None
        return SequentialDedupForward(model, dataset, verify_fn=verify_fn,
                                      verify_tol=self.dedup_tolerance())

    # ---------------- data ----------------

    def _dataset_cls(self):
        from streamyolo_torch.data.datasets import (
            ONE_ARGOVERSEDataset,
            STILL_ARGOVERSEDataset,
            TWO_ARGOVERSEDataset,
        )

        return {"one": ONE_ARGOVERSEDataset, "two": TWO_ARGOVERSEDataset,
                "still": STILL_ARGOVERSEDataset}[self.dataset_name]

    def get_data_loader(self, batch_size: int, is_distributed: bool = False,
                        no_aug: bool = False, cache_img: bool = False,
                        load_frame: Optional[Callable[[dict], np.ndarray]] = None):
        """The train loader: the train split through the mosaic wrapper
        (mosaic, and for STILL the mixup, unless ``no_aug``; then the
        shared-flip mirror, letterbox, 120 labels), batches from
        ``InfiniteSampler`` seeded by ``seed`` (0 if unset). ``cache_img``
        reads the frames from the dataset's memmap (``--cache``).
        ``batch_size`` is the global batch: under a process group each rank
        loads ``batch_size // world`` (the division must be exact) from the
        sampler strided by its rank, as the JAX package does whatever
        ``is_distributed`` says. ``load_frame`` supplies the pixels as in
        ``get_eval_loader``."""
        from streamyolo_torch.data.loader import (
            DataLoader,
            InfiniteSampler,
            YoloBatchSampler,
            _IndexUnpackDataset,
            worker_init_reset_seed,
        )
        from streamyolo_torch.data.mosaic import MosaicDetection, StillMosaicDetection
        from streamyolo_torch.data.transforms import DoubleTrainTransform, TrainTransform
        from streamyolo_torch.parallel import get_rank, get_world_size, local_batch_size

        double = self.dataset_name in ("one", "two")
        transform_cls = DoubleTrainTransform if double else TrainTransform
        dataset = self._dataset_cls()(
            data_dir=self.data_dir, json_file=self.train_ann, name="train",
            img_size=self.input_size,
            preproc=transform_cls(max_labels=50, hsv=False, flip=True),
            cache=cache_img, load_frame=load_frame)
        wrapper_cls = MosaicDetection if double else StillMosaicDetection
        dataset = wrapper_cls(
            dataset, mosaic=not no_aug, img_size=self.input_size,
            preproc=transform_cls(max_labels=120, hsv=False, flip=True),
            degrees=self.degrees, translate=self.translate, scale=self.mosaic_scale,
            shear=self.shear, perspective=0.0, enable_mixup=self.enable_mixup,
            mosaic_prob=self.mosaic_prob, mixup_prob=self.mixup_prob)
        self.dataset = dataset
        sampler = InfiniteSampler(len(dataset), seed=self.seed if self.seed else 0,
                                  rank=get_rank(), world_size=get_world_size())
        batch_sampler = YoloBatchSampler(sampler=sampler,
                                         batch_size=local_batch_size(batch_size),
                                         drop_last=False, mosaic=not no_aug)
        return DataLoader(_IndexUnpackDataset(dataset), num_workers=self.data_num_workers,
                          batch_sampler=batch_sampler, worker_init_fn=worker_init_reset_seed)

    def get_eval_loader(self, batch_size: int, is_distributed: bool = False,
                        testdev: bool = False,
                        load_frame: Optional[Callable[[dict], np.ndarray]] = None):
        """The val loader in dataset order (shuffle off). ``load_frame``
        (image dict -> BGR uint8) supplies the pixels; by default they are
        read from ``data_dir`` by ``data/image_io.py::imread`` (no cv2). Under a process group of more than
        one rank the loader reads the rank's strided shard of the val set,
        as the JAX package's does whatever ``is_distributed`` says (its
        evaluator gathers the detections)."""
        from streamyolo_torch.data.loader import DataLoader, ShardDataset
        from streamyolo_torch.data.transforms import DoubleValTransform, ValTransform
        from streamyolo_torch.parallel import get_rank, get_world_size

        double = self.dataset_name in ("one", "two")
        valdataset = self._dataset_cls()(
            data_dir=self.data_dir, json_file=self.val_ann, name="val",
            img_size=self.test_size,
            preproc=DoubleValTransform() if double else ValTransform(),
            load_frame=load_frame)
        if get_world_size() > 1:
            valdataset = ShardDataset(valdataset, get_rank(), get_world_size())
        return DataLoader(valdataset, num_workers=self.data_num_workers,
                          batch_size=batch_size, shuffle=False)

    def get_evaluator(self, batch_size: int, is_distributed: bool = False,
                      testdev: bool = False,
                      load_frame: Optional[Callable[[dict], np.ndarray]] = None):
        from streamyolo_torch.eval.evaluators import (
            ONEX_COCOEvaluator,
            STILL_COCOEvaluator,
            TWOX_COCOEvaluator,
        )

        evaluator_cls = {"onex": ONEX_COCOEvaluator, "twox": TWOX_COCOEvaluator,
                         "still": STILL_COCOEvaluator}[self.evaluator_name]
        return evaluator_cls(
            dataloader=self.get_eval_loader(batch_size, is_distributed, testdev, load_frame),
            img_size=self.test_size, confthre=self.test_conf, nmsthre=self.nmsthre,
            num_classes=self.num_classes, testdev=testdev)

    def eval(self, forward_fn, evaluator, is_distributed: bool = None, half: bool = False):
        return evaluator.evaluate(forward_fn, is_distributed, half)

    # ---------------- training ----------------

    def get_lr_schedule(self, batch_size: int, iters_per_epoch: int) -> Callable[[int], float]:
        """The schedule of ``scheduler`` at ``lr = basic_lr_per_img * batch_size``."""
        return self.get_lr_scheduler(self.basic_lr_per_img * batch_size, iters_per_epoch)

    def get_lr_scheduler(self, lr: float, iters_per_epoch: int) -> Callable[[int], float]:
        """The reference's name and calling convention (the LR itself)."""
        from streamyolo_torch.train.lr import build_lr_schedule

        return build_lr_schedule(
            self.scheduler, lr=lr, iters_per_epoch=iters_per_epoch, max_epoch=self.max_epoch,
            warmup_epochs=self.warmup_epochs, warmup_lr_start=self.warmup_lr,
            min_lr_ratio=self.min_lr_ratio, no_aug_epochs=self.no_aug_epochs)

    def get_trainer(self, args):
        from streamyolo_torch.train.trainer import Trainer

        return Trainer(self, args)

    def random_resize(self, step: int, epoch: int) -> Tuple[int, int]:
        """The multiscale input size of 10-step window ``step``: the same on
        every process without a broadcast; the last epoch keeps
        ``input_size``."""
        if self.random_size is None or epoch >= self.max_epoch - 1:
            return tuple(self.input_size)
        rng = np.random.RandomState((self.seed or 0) * 1_000_003 + step)
        size = int(rng.randint(self.random_size[0], self.random_size[1] + 1))
        size_factor = self.input_size[0] * 1.0 / self.input_size[1]
        return (16 * int(size * size_factor), 16 * size)

    def preprocess(self, inputs: torch.Tensor, targets: Sequence[torch.Tensor], tsize):
        """Resize an NHWC batch (uint8 or float) to ``tsize`` on its device
        (``F.interpolate`` bilinear, ``align_corners=False``, no
        antialiasing; float32 out) and scale the cxcywh labels: columns
        ``1::2`` by the x scale, ``2::2`` by the y scale. The same size
        returns the inputs as they are."""
        scale_y = tsize[0] / self.input_size[0]
        scale_x = tsize[1] / self.input_size[1]
        if scale_x == 1 and scale_y == 1:
            return inputs, tuple(targets)
        x = inputs.permute(0, 3, 1, 2)
        if not x.is_floating_point():
            x = x.float()  # the uint8 host pipeline
        x = F.interpolate(x, size=(tsize[0], tsize[1]), mode="bilinear",
                          align_corners=False, antialias=False)
        scaled = []
        for t in targets:
            t = t.clone()
            t[..., 1::2] *= scale_x
            t[..., 2::2] *= scale_y
            scaled.append(t)
        return x.permute(0, 2, 3, 1), tuple(scaled)
