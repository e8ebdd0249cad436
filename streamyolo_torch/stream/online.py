"""Online streaming detection on the card: the counterpart of
``streamyolo_tpu/stream/online.py``.

Detectors:

  * ``CUDAStreamDetector`` (``TPUStreamDetector``), per frame: uint8 frame ->
    (optional 0.5x downsample on the device, kernel B2) -> cast -> backbone
    ONCE -> DFP fuse with the carried buffer -> head -> decode ->
    fixed-shape NMS (kernel B1) -> one [K, 8] device-to-host copy;
  * ``MultiStreamDetector``: N camera streams in one batched step (one H2D,
    one kernel-B1 launch of grid N, one [N, K, 8] D2H), with per-stream
    restarts through the model's ``star_mask``.

The DFP buffer stays on the device: the star step's features become the
buffer, and every later step writes the current features into the same
tensors in place (the analogue of the JAX step's ``donate_argnums=2``).

Harness (host only, the same code for both clocks): ``stream_sequence``
runs the streaming protocol over one sequence, with ``WallClock`` on the
card or with ``SimClock`` plus an ``Empirical`` latency distribution, where
the run is deterministic on any host; ``run_streaming_detection`` runs a
whole dataset and writes the per-sequence pkls and ``time_info.pkl``;
``stream_sequence_infinite`` simulates one accelerator per frame.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from streamyolo_torch.ops.nms import postprocess_fixed
from streamyolo_torch.ops.preproc import downsample2x
from streamyolo_torch.stream.clock import SimClock, WallClock
from streamyolo_torch.stream.runtime_dist import Empirical
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


def _place(model: torch.nn.Module, device: torch.device, use_bf16: bool) -> torch.nn.Module:
    """The model on ``device`` in eval mode, channels_last on a card (the
    layout cuDNN's NHWC convolutions read without a copy)."""
    _warn_if_fp32_built(model, use_bf16)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _carry(buffer, cur):
    """The next DFP buffer: ``cur`` itself after the star step, else
    ``cur`` written into the existing buffer tensors (same memory and
    layout)."""
    if buffer is None:
        return cur
    for buf, c in zip(buffer, cur):
        buf.copy_(c)
    return buffer


def _parse(rows: np.ndarray, in_scale: float):
    """One image's [K, 8] rows -> (bboxes_ltrb / in_scale, scores, int
    labels, None-masks) of the kept rows."""
    kept = rows[rows[:, 7] > 0.5]
    return (kept[:, :4] / in_scale, kept[:, 4] * kept[:, 5],
            kept[:, 6].astype(np.int32), None)


def _host_resize(frame_bgr: np.ndarray, input_size: Tuple[int, int]) -> np.ndarray:
    """Plain resize to the streaming input size (the online path does not
    letterbox); stays uint8, the cast happens on the device."""
    import cv2

    return cv2.resize(frame_bgr, (input_size[1], input_size[0]),
                      interpolation=cv2.INTER_LINEAR)


def _saturated(rows: np.ndarray, conf_thre: float) -> bool:
    """All K slots above conf: candidates were dropped before NMS."""
    return int((rows[:, 4] * rows[:, 5] >= conf_thre).sum()) >= rows.shape[0]


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
        self.model = _place(model, self.device, use_bf16)
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
        return _host_resize(frame_bgr, self.input_size)

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
        self._buffer = _carry(self._buffer, cur)
        return dets

    def __call__(self, frame_bgr: np.ndarray, preprocessed: bool = False):
        frame = frame_bgr if preprocessed else self.preproc(frame_bgr)
        image = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)[None]
        rows = self.step(image)[0].cpu().numpy()  # [K, 8]: the only per-frame D2H
        self.last_rows = rows
        if _saturated(rows, self.conf_thre):
            self.n_saturated += 1
            if self.n_saturated <= 3 or self.n_saturated % 100 == 0:
                get_logger().warning(
                    "streaming pre-NMS selection saturated (%d candidates "
                    "above conf %.4g; frame count %d) — raise pre_nms_topk "
                    "for dense scenes",
                    self.pre_nms_topk, self.conf_thre, self.n_saturated,
                )
        return _parse(rows, self.in_scale)


class MultiStreamDetector:
    """N independent camera streams batched through ONE on_pipe step.

    The on_pipe step is row-wise independent (each batch row carries its own
    slice of the DFP buffer), so N streams cost one batched step instead of
    N single-frame steps: one H2D of [N, H, W, 3] uint8, one model pass, one
    ``postprocess_fixed`` over [N, K, 8] with ONE kernel-B1 launch of grid N
    (one block per stream), one D2H.

    Per-stream restarts (a camera drops and reconnects) use the model's
    ``star_mask``: ``reset(i)`` marks row ``i``, whose next step fuses with
    its OWN current features while the other rows keep their carry. When no
    row is marked the mask is not passed, which gives exactly the buffer
    select of an all-False mask without its three ``where`` launches.

    Call contract: ``det(frames)`` with ``frames`` a sequence of
    ``n_streams`` BGR frames (or a stacked [N, H, W, 3] array) returns a
    list of ``n_streams`` ``(bboxes_ltrb / in_scale, scores, labels, None)``
    tuples, each ``CUDAStreamDetector``'s parse contract for that stream.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        n_streams: int,
        input_size: Tuple[int, int] = (600, 960),
        in_scale: float = 0.5,
        conf_thre: float = 0.01,
        nms_thre: float = 0.65,
        num_classes: int = 8,
        pre_nms_topk: int = 200,
        use_bf16: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.device = resolve_device(device)
        self.n_streams = n_streams
        self.input_size = tuple(input_size)
        self.in_scale = in_scale
        self.conf_thre = conf_thre
        self.nms_thre = nms_thre
        self.num_classes = num_classes
        self.pre_nms_topk = pre_nms_topk
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.n_saturated = 0  # images where the top-k candidate cap bit
        self.last_rows = None  # the latest step's [N, K, 8] block, on the host
        self.model = _place(model, self.device, use_bf16)
        self._buffer = None
        self._pending_star = np.zeros(n_streams, bool)

    def reset(self, stream: Optional[int] = None):
        """``reset()`` restarts every stream (the next step is the all-star
        step); ``reset(i)`` marks stream ``i`` to re-star on the next step
        while the other streams keep their carry."""
        if stream is None:
            self._buffer = None
            self._pending_star[:] = False
            return
        if not 0 <= stream < self.n_streams:
            raise IndexError(
                f"stream index {stream} out of range [0, {self.n_streams})")
        self._pending_star[stream] = True

    def warmup(self, n: int = 10):
        """Run ``n`` batches of zeros through the star and steady steps."""
        frames = np.zeros((self.n_streams, *self.input_size, 3), np.uint8)
        self.reset()
        for _ in range(n):
            self(frames, preprocessed=True)
        self.reset()

    def preproc(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Per-stream host resize (``CUDAStreamDetector``'s host path)."""
        return _host_resize(frame_bgr, self.input_size)

    @torch.inference_mode()
    def step(self, images: torch.Tensor) -> torch.Tensor:
        """One batched device step: [N, H, W, 3] uint8 on ``self.device`` ->
        [N, K, 8] rows, still on the device. Consumes the pending per-stream
        stars (a reset before the first step is absorbed by the all-star
        step) and updates the buffer in place."""
        star_mask = None
        if self._buffer is not None and self._pending_star.any():
            star_mask = torch.from_numpy(self._pending_star.copy()).to(
                self.device, non_blocking=True)
        preds, cur = self.model(images.to(self.compute_dtype), buffer=self._buffer,
                                mode="on_pipe", star_mask=star_mask)
        dets = postprocess_fixed(
            preds, num_classes=self.num_classes, conf_thre=self.conf_thre,
            nms_thre=self.nms_thre, pre_nms_topk=self.pre_nms_topk)
        self._buffer = _carry(self._buffer, cur)
        self._pending_star[:] = False
        return dets

    def __call__(self, frames, preprocessed: bool = False):
        if not preprocessed:
            frames = np.stack([self.preproc(f) for f in frames])
        else:
            frames = np.asarray(frames)
            if frames.ndim == 3 and self.n_streams == 1:
                frames = frames[None]  # a single unstacked frame, 1 stream
        if frames.shape[0] != self.n_streams:
            raise AssertionError(
                f"expected {self.n_streams} frames, got {frames.shape[0]}")
        images = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        rows_all = self.step(images).cpu().numpy()  # [N, K, 8]: the only D2H
        self.last_rows = rows_all
        out = []
        for rows in rows_all:
            if _saturated(rows, self.conf_thre):
                self.n_saturated += 1
                if self.n_saturated <= 3 or self.n_saturated % 100 == 0:
                    get_logger().warning(
                        "multi-stream pre-NMS selection saturated (%d "
                        "candidates above conf %.4g; count %d) — raise "
                        "pre_nms_topk for dense scenes",
                        self.pre_nms_topk, self.conf_thre, self.n_saturated,
                    )
            out.append(_parse(rows, self.in_scale))
        return out


class SimulatedDetector:
    """Oracle detector for simulated runs: emits the ground truth of the
    input frame index and reports no time of its own (the clock advances by
    draws from ``runtime_dist`` in ``stream_sequence``)."""

    def __init__(self, gt_by_fidx, runtime_dist: Empirical):
        self.gt_by_fidx = gt_by_fidx
        self.runtime_dist = runtime_dist

    def reset(self):
        pass

    def __call__(self, fidx: int):
        boxes, labels = self.gt_by_fidx(fidx)
        scores = np.ones(len(boxes))
        return np.asarray(boxes, np.float64), scores, np.asarray(labels, np.int32), None


def stream_sequence(
    frames: Sequence,
    detector,
    fps: float = 30.0,
    clock=None,
    det_stride: int = 1,
    dynamic_schedule: bool = False,
    runtime_dist: Optional[Empirical] = None,
    frame_arg_is_index: bool = False,
) -> Dict[str, list]:
    """Run the streaming protocol over one sequence: repeatedly take the
    LATEST frame ``floor(elapsed * fps)``, skipping frames already seen
    (and strided ones, or with ``dynamic_schedule`` a frame more than half
    its period late), run the detector, and record the result's completion
    time.

    With ``clock=WallClock()`` and a real detector this is the production
    loop; with ``clock=SimClock()`` + ``runtime_dist`` the detector's latency
    is simulated and the run is deterministic on any host.
    """
    clock = clock or WallClock()
    clock.reset()
    n_frame = len(frames)
    t_total = n_frame / fps

    timestamps: List[float] = []
    results_parsed: List[tuple] = []
    input_fidx: List[int] = []
    runtime: List[float] = []
    last_fidx = None
    stride_cnt = 0
    detector.reset()

    while True:
        t1 = clock.now()
        if t1 >= t_total:
            break
        fidx_continous = t1 * fps
        fidx = int(np.floor(fidx_continous))
        if fidx == last_fidx:
            # real clock: busy-wait until the next frame; sim clock: hop to it
            if isinstance(clock, SimClock):
                clock.advance((fidx + 1) / fps - t1 + 1e-9)
            continue
        last_fidx = fidx
        if dynamic_schedule:
            if fidx_continous - fidx > 0.5:  # more than half a period late
                continue
        else:
            if stride_cnt % det_stride == 0:
                stride_cnt = 1
            else:
                stride_cnt += 1
                continue

        arg = fidx if frame_arg_is_index else frames[fidx]
        result = detector(arg)
        if runtime_dist is not None:
            dt = runtime_dist.draw()
            clock.advance(dt)
        t2 = clock.now()
        if t2 >= t_total:
            break
        timestamps.append(t2)
        results_parsed.append(result)
        input_fidx.append(fidx)
        runtime.append(t2 - t1)

    return {
        "results_parsed": results_parsed,
        "timestamps": timestamps,
        "input_fidx": input_fidx,
        "runtime": runtime,
    }


def print_stats(arr, name: str = "", fmt: str = "{:.4g}", cvt=lambda x: x):
    """Log one line of mean / std / min / max of ``arr``."""
    arr = np.asarray(arr)
    get_logger().info(
        f"{name}: mean: {fmt.format(cvt(arr.mean()))}; std: {fmt.format(cvt(arr.std(ddof=1)))}; "
        f"min: {fmt.format(cvt(arr.min()))}; max: {fmt.format(cvt(arr.max()))}"
    )


def imread_loader(db, data_root: str) -> Callable[[dict], np.ndarray]:
    """``load_frame`` for an Argoverse-HD layout: reads
    ``data_root/<seq_dir>/<name>`` of an image dict with cv2."""
    import cv2

    seq_dirs = db.dataset["seq_dirs"]

    def load(img: dict) -> np.ndarray:
        path = os.path.join(data_root, seq_dirs[img["sid"]], img["name"])
        frame = cv2.imread(path)
        if frame is None:
            raise OSError(f"cannot read {path}")
        return frame

    return load


def run_streaming_detection(
    db,
    data_root: str,
    out_dir: str,
    detector,
    fps: float = 30.0,
    det_stride: int = 1,
    dynamic_schedule: bool = False,
    clock=None,
    runtime_dist: Optional[Empirical] = None,
    overwrite: bool = False,
    load_frame: Optional[Callable[[dict], np.ndarray]] = None,
) -> Dict:
    """Whole-dataset streaming run: per-sequence pkls + ``time_info.pkl``.
    ``db`` is a COCO index whose dataset carries ``sequences`` +
    ``seq_dirs``. Each sequence's raw frames are loaded before its clock
    starts: by ``load_frame(image_dict)`` if given (e.g.
    ``SyntheticArgoverse.frame``, no cv2 needed), else by
    ``imread_loader(db, data_root)``."""
    logger = get_logger()
    os.makedirs(out_dir, exist_ok=True)
    seqs = db.dataset["sequences"]
    load_frame = load_frame or imread_loader(db, data_root)

    runtime_all: List[float] = []
    n_processed = 0
    n_total = 0
    for sid, seq in enumerate(seqs):
        # preprocessing stays inside the clock (the detector resizes);
        # only the raw frames are preloaded
        frames = [load_frame(img) for img in db.imgs.values() if img["sid"] == sid]
        n_total += len(frames)

        result = stream_sequence(
            frames, detector, fps=fps, clock=clock,
            det_stride=det_stride, dynamic_schedule=dynamic_schedule,
            runtime_dist=runtime_dist,
        )
        out_path = os.path.join(out_dir, seq + ".pkl")
        if overwrite or not os.path.isfile(out_path):
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
        runtime_all += result["runtime"]
        n_processed += len(result["results_parsed"])

    runtime_all_np = np.asarray(runtime_all)
    n_small_runtime = int((runtime_all_np < 1.0 / fps).sum()) if len(runtime_all) else 0
    time_info = {
        "runtime_all": runtime_all,
        "n_processed": n_processed,
        "n_total": n_total,
        "n_small_runtime": n_small_runtime,
    }
    out_path = os.path.join(out_dir, "time_info.pkl")
    if overwrite or not os.path.isfile(out_path):
        with open(out_path, "wb") as f:
            pickle.dump(time_info, f)

    logger.info(f"{n_processed}/{n_total} frames processed")
    if len(runtime_all):
        print_stats(runtime_all_np, "Runtime (ms)", cvt=lambda x: 1e3 * x)
        logger.info(
            f"Runtime smaller than unit time interval: "
            f"{n_small_runtime}/{n_processed} "
            f"({100.0 * n_small_runtime / max(n_processed, 1):.4g}%)"
        )
    return time_info


def stream_sequence_infinite(
    frames: Sequence,
    detector,
    fps: float = 30.0,
    runtime_dist: Optional[Empirical] = None,
    frame_arg_is_index: bool = False,
) -> Dict[str, list]:
    """Infinite-compute simulation: EVERY frame is processed (as if by its
    own accelerator) and its result becomes visible at frame_time +
    runtime, which isolates algorithmic latency from device count. Results
    come out in completion-time order, as the pairing pass reads a real
    run."""
    n_frame = len(frames)
    detector.reset()
    entries = []
    for fidx in range(n_frame):
        arg = fidx if frame_arg_is_index else frames[fidx]
        result = detector(arg)
        rt = runtime_dist.draw() if runtime_dist is not None else 0.0
        entries.append((fidx / fps + rt, fidx, result, rt))
    entries.sort(key=lambda e: e[0])
    horizon = n_frame / fps
    out = {"results_parsed": [], "timestamps": [], "input_fidx": [], "runtime": []}
    for ts, fidx, result, rt in entries:
        if ts >= horizon:
            continue
        out["timestamps"].append(ts)
        out["results_parsed"].append(result)
        out["input_fidx"].append(fidx)
        out["runtime"].append(rt)
    return out
