"""Online streaming detector on the card: the counterpart of
``streamyolo_tpu/stream/online.py::TPUStreamDetector``.

Per frame: uint8 frame -> (optional 0.5x downsample on the device, kernel
B2) -> cast -> backbone ONCE -> DFP fuse with the carried buffer -> head ->
decode -> fixed-shape NMS (kernel B1) -> one [K, 8] device-to-host copy.

The DFP buffer stays on the device: the star frame's features become the
buffer, and every later step writes the current features into the same
tensors in place (the analogue of the JAX step's ``donate_argnums=2``).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from streamyolo_torch.ops.nms import postprocess_fixed
from streamyolo_torch.ops.preproc import downsample2x
from streamyolo_torch.utils.device import resolve_device
from streamyolo_torch.utils.logger import get_logger


def _warn_if_fp32_built(model: torch.nn.Module, use_bf16: bool) -> None:
    """The step casts the INPUT to the compute dtype, but the model casts it
    on to its own modules' dtype: an fp32-built model runs the whole trunk
    fp32 behind ``use_bf16``. Build the model bf16 instead."""
    if use_bf16 and next(model.parameters()).dtype == torch.float32:
        get_logger().warning(
            "use_bf16=True but the model's modules are built fp32 — the "
            "trunk will compute fp32 anyway; build the model with "
            "dtype=torch.bfloat16")


class CUDAStreamDetector:
    """Stateful streaming detector carrying the DFP buffer across frames.

    Parse contract (as ``TPUStreamDetector``): returns
    (bboxes_ltrb / in_scale, scores, int labels, None-masks)."""

    def __init__(
        self,
        model: torch.nn.Module,
        input_size: Tuple[int, int] = (600, 960),
        in_scale: float = 0.5,
        conf_thre: float = 0.01,
        nms_thre: float = 0.65,
        num_classes: int = 8,
        pre_nms_topk: int = 200,
        use_bf16: bool = True,
        device_preproc: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.input_size = tuple(input_size)
        self.in_scale = in_scale
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.num_classes = num_classes
        self.pre_nms_topk = pre_nms_topk
        self.device_preproc = device_preproc
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.n_saturated = 0  # frames where the top-k candidate cap bit
        self.last_rows = None  # the latest frame's [K, 8] block, on the host
        _warn_if_fp32_built(model, use_bf16)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self._buffer = None

    def reset(self):
        self._buffer = None

    def warmup(self, n: int = 10):
        """Run ``n`` frames of zeros through the star and steady steps."""
        scale = 2 if self.device_preproc else 1
        frame = np.zeros(
            (scale * self.input_size[0], scale * self.input_size[1], 3), np.uint8)
        self.reset()
        for _ in range(n):
            self(frame, preprocessed=True)
        self.reset()

    def preproc(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Plain resize to the streaming input size (the online path does not
        letterbox); stays uint8, the cast happens on the device. With
        ``device_preproc`` the raw frame must be exactly 2x the input size."""
        if self.device_preproc:
            want = (2 * self.input_size[0], 2 * self.input_size[1])
            if frame_bgr.shape[:2] != want:
                raise ValueError(
                    f"device_preproc expects raw {want[0]}x{want[1]} frames "
                    f"(2x the input size), got {frame_bgr.shape[:2]} — use "
                    "device_preproc=False for other source resolutions")
            return frame_bgr
        import cv2

        return cv2.resize(
            frame_bgr, (self.input_size[1], self.input_size[0]),
            interpolation=cv2.INTER_LINEAR)

    @torch.inference_mode()
    def step(self, image: torch.Tensor) -> torch.Tensor:
        """One device step: [1, H, W, 3] uint8 (raw [1, 2H, 2W, 3] with
        ``device_preproc``) on ``self.device`` -> [1, K, 8] rows, still on
        the device. Updates the buffer."""
        if self.device_preproc:
            x = downsample2x(image[0], out_dtype=self.compute_dtype, fused=True)[None]
        else:
            x = image.to(self.compute_dtype)
        preds, cur = self.model(x, buffer=self._buffer, mode="on_pipe")
        dets = postprocess_fixed(
            preds, num_classes=self.num_classes, conf_thre=self.conf_thre,
            nms_thre=self.nms_thre, pre_nms_topk=self.pre_nms_topk)
        if self._buffer is None:
            self._buffer = cur
        else:
            for buf, c in zip(self._buffer, cur):
                buf.copy_(c)
        return dets

    def __call__(self, frame_bgr: np.ndarray, preprocessed: bool = False):
        frame = frame_bgr if preprocessed else self.preproc(frame_bgr)
        image = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)[None]
        rows = self.step(image)[0].cpu().numpy()  # [K, 8]: the only per-frame D2H
        self.last_rows = rows
        if int((rows[:, 4] * rows[:, 5] >= self.conf_thre).sum()) >= rows.shape[0]:
            self.n_saturated += 1
            if self.n_saturated <= 3 or self.n_saturated % 100 == 0:
                get_logger().warning(
                    "streaming pre-NMS selection saturated (%d candidates "
                    "above conf %.4g; frame count %d) — raise pre_nms_topk "
                    "for dense scenes",
                    self.pre_nms_topk, self.conf_thre, self.n_saturated,
                )
        kept = rows[rows[:, 7] > 0.5]
        bboxes = kept[:, :4] / self.in_scale
        scores = kept[:, 4] * kept[:, 5]
        labels = kept[:, 6].astype(np.int32)
        return bboxes, scores, labels, None
