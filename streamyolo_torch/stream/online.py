"""Online streaming detection on the card: the counterpart of
``streamyolo_tpu/stream/online.py``.

Detectors:

  * ``CUDAStreamDetector`` (``TPUStreamDetector``), per frame: uint8 frame ->
    (optional 0.5x downsample on the device, kernel B2) -> cast -> backbone
    ONCE -> DFP fuse with the carried buffer -> head -> decode ->
    fixed-shape NMS (kernel B1) -> one [K, 8] device-to-host copy; with
    ``mesh`` (``parallel/spatial.py``, the JAX detector's spatial latency
    mode) each frame's rows are sliced over the mesh's devices, the DFP
    buffer stays sharded, and the decode and NMS run on the first device;
  * ``MultiStreamDetector``: N camera streams in one batched step (one H2D,
    one kernel-B1 launch of grid N, one [N, K, 8] D2H), with per-stream
    restarts through the model's ``star_mask``.

The DFP buffer stays on the device: the star step's features become the
buffer, and every later step writes the current features into the same
tensors in place (the analogue of the JAX step's ``donate_argnums=2``).

Serving from captured graphs (``aot_dir``, the JAX detectors' serialized
executables): ``export_stream_executables`` /
``export_multi_stream_executables`` (``tools/precompile.py --serve``) write
per configuration key a manifest of each graph and the kernel libraries the
graphs launch (``utils/aot.py``). A detector built with ``aot_dir`` whose
key hits loads those libraries (no ``nvcc``), captures its star and steady
steps (``_build_stream_step`` / ``_build_multi_stream_step`` over static
tensors) as two CUDA graphs in one memory pool, and probes both against its
eager step bit for bit before ``aot_loaded`` is set; a frame is then one
copy into the static input, one replay and the one D2H of the rows. On the
CPU the same static steps run as they are. A miss, a failed capture or a
probe that differs is logged and leaves the detector serving eagerly.

Harness (host only, the same code for both clocks): ``stream_sequence``
runs the streaming protocol over one sequence, with ``WallClock`` on the
card or with ``SimClock`` plus an ``Empirical`` latency distribution, where
the run is deterministic on any host; ``run_streaming_detection`` runs a
whole dataset and writes the per-sequence pkls and ``time_info.pkl``;
``stream_sequence_infinite`` simulates one accelerator per frame.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from streamyolo_torch.ops.nms import postprocess_fixed
from streamyolo_torch.ops.preproc import downsample2x
from streamyolo_torch.parallel.spatial import SpatialStreamYOLO
from streamyolo_torch.stream.clock import SimClock, WallClock
from streamyolo_torch.stream.runtime_dist import Empirical
from streamyolo_torch.utils.aot import (capture_graphs, environment, executable_key,
                                        file_digest, load_manifest, save_manifest)
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


def _build_stream_step(model, *, num_classes, conf_thre, nms_thre, pre_nms_topk,
                       compute_dtype, device_preproc):
    """``CUDAStreamDetector``'s per-frame device program, the one function
    its eager step runs and its CUDA graphs capture: ``step(image, buffer,
    star, out=None) -> (rows, buffer)`` takes the [1, H, W, 3] uint8 frame
    (raw [1, 2H, 2W, 3] with ``device_preproc``: kernel B2), runs the
    on_pipe model (``star``: the frame fuses with itself and ``buffer`` is
    not read), computes the [1, K, 8] ``postprocess_fixed`` rows (kernel
    B1), written into ``out`` when given, and then carries the frame's
    features (``_carry``: into ``buffer`` in place, after the fuse has read
    it; ``cur`` itself when ``buffer`` is None, the eager star step). Over
    static ``image``, ``buffer`` and ``out`` it allocates nothing that
    outlives the call."""

    def step(image, buffer, star: bool, out=None):
        if device_preproc:
            x = downsample2x(image[0], out_dtype=compute_dtype, fused=True)[None]
        else:
            x = image.to(compute_dtype)
        preds, cur = model(x, buffer=None if star else buffer, mode="on_pipe")
        rows = postprocess_fixed(preds, num_classes=num_classes, conf_thre=conf_thre,
                                 nms_thre=nms_thre, pre_nms_topk=pre_nms_topk)
        if out is not None:
            rows = out.copy_(rows)
        return rows, _carry(buffer, cur)

    return step


def _build_spatial_step(spatial, *, num_classes, conf_thre, nms_thre, pre_nms_topk,
                        compute_dtype):
    """``_build_stream_step``'s eager step with the frame's rows sliced over
    a mesh (``parallel/spatial.py::SpatialStreamYOLO``): ``step(image,
    buffer, star)`` copies each device's rows of the [1, H, W, 3] uint8
    frame to it, runs the sharded on_pipe model, computes the [1, K, 8] rows
    on the primary device (kernel B1), and carries the sharded features (one
    tuple of slabs per level) into ``buffer`` in place."""

    def step(image, buffer, star: bool):
        parts = [p.to(compute_dtype) for p in spatial.sharding.shard(image, dim=1)]
        preds, cur = spatial(parts, buffer=None if star else buffer)
        rows = postprocess_fixed(preds, num_classes=num_classes, conf_thre=conf_thre,
                                 nms_thre=nms_thre, pre_nms_topk=pre_nms_topk)
        if buffer is None:
            return rows, cur
        for level, c in zip(buffer, cur):
            _carry(level, c)
        return rows, buffer

    return step


def _build_multi_stream_step(model, *, num_classes, conf_thre, nms_thre, pre_nms_topk,
                             compute_dtype):
    """``MultiStreamDetector``'s batched program, as ``_build_stream_step``:
    ``step(images, buffer, star, star_mask, out=None) -> (rows, buffer)``
    with [N, H, W, 3] uint8 frames and [N, K, 8] rows. ``star``: the
    all-star step (the buffer is not read); else the [N] bool
    ``star_mask``'s True rows re-star and the others read the buffer. The
    eager step passes no mask when no row restarts, the captured steady
    step always the static one (an all-False mask selects the buffer for
    every row)."""

    def step(images, buffer, star: bool, star_mask, out=None):
        preds, cur = model(images.to(compute_dtype), buffer=None if star else buffer,
                           mode="on_pipe", star_mask=None if star else star_mask)
        rows = postprocess_fixed(preds, num_classes=num_classes, conf_thre=conf_thre,
                                 nms_thre=nms_thre, pre_nms_topk=pre_nms_topk)
        if out is not None:
            rows = out.copy_(rows)
        return rows, _carry(buffer, cur)

    return step


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _stream_aot_key(model: torch.nn.Module, image_shape, device: torch.device,
                    **config) -> str:
    """Content key of a detector's captured steps: the model's structure
    (its repr), its state dict's names, shapes and dtypes (not the values:
    the graphs read the parameters in place, so new weights of the same
    shapes reuse the key), the exact input shape, every postprocess knob,
    and the environment (``utils/aot.py::executable_key``)."""
    avals = [(k, tuple(v.shape), str(v.dtype)) for k, v in model.state_dict().items()]
    config.setdefault("kind", "stream_step")
    return executable_key(device, model=_sha(repr(model)), variables=_sha(repr(avals)),
                          image_shape=tuple(image_shape), **config)


def _stream_executable_paths(aot_dir: str, key: str) -> Tuple[str, str]:
    """The (star, steady) graph manifests of ``key`` under ``aot_dir``."""
    stem = os.path.join(aot_dir, f"stream_{key[:20]}")
    return stem + ".star.json", stem + ".buf.json"


def _check_shape(image: torch.Tensor, static: torch.Tensor) -> None:
    """The captured steps take one input shape (``copy_`` would broadcast)."""
    if tuple(image.shape) != tuple(static.shape) or image.dtype != static.dtype:
        raise ValueError(f"the captured steps take {tuple(static.shape)} {static.dtype} "
                         f"frames, got {tuple(image.shape)} {image.dtype}")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


class GraphSteps:
    """A detector's star and steady steps over its static tensors: on a card
    two CUDA graphs captured into one memory pool (``utils/aot.py::
    capture_graphs``), on the CPU the two functions run as they are.

    ``capture_seconds`` and ``captured`` (kernel launches recorded into each
    graph, by kernel) are per graph, (star, steady); ``replays`` counts each
    graph's runs, and ``launches()`` the kernel launches those replays made
    (the wrappers' counters see only the capture)."""

    def __init__(self, star_fn, steady_fn, device: torch.device):
        if device.type == "cuda":
            graphs, self.capture_seconds, self.captured = capture_graphs(
                [star_fn, steady_fn], device)
            self._runs = tuple(g.replay for g in graphs)
        else:
            self._runs = (star_fn, steady_fn)
            self.capture_seconds, self.captured = [None, None], [{}, {}]
        self.replays = [0, 0]

    def run(self, star: bool) -> None:
        i = 0 if star else 1
        self._runs[i]()
        self.replays[i] += 1

    def launches(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for captured, n in zip(self.captured, self.replays):
            for kernel, count in captured.items():
                out[kernel] = out.get(kernel, 0) + count * n
        return out


class _GraphServing:
    """What both detectors share to serve from captured graphs: the key, the
    manifests and libraries under ``aot_dir``, export, and the probe.

    A subclass provides ``_aot_config()`` (the key's parts), ``_image_shape()``
    and ``_capture()``, which captures its steps and returns the
    ``GraphSteps`` with the rows of its probe steps and the buffer after
    them, eager and replayed."""

    graphs: Optional[GraphSteps] = None
    aot_loaded = False

    def _aot_key(self) -> str:
        return _stream_aot_key(self.model, self._image_shape(), self.device,
                               **self._aot_config())

    def _probe_frames(self, n: int) -> List[torch.Tensor]:
        rng = np.random.RandomState(0)
        return [torch.from_numpy(rng.randint(0, 256, self._image_shape(), np.uint8)).to(
            self.device) for _ in range(n)]

    @torch.inference_mode()
    def _capture_probed(self) -> GraphSteps:
        """Capture the steps and hold every probe step's rows and the final
        buffer, replayed, against the eager steps of the same frames, bit
        for bit; raises ``RuntimeError`` naming what differs. Leaves the
        detector reset, also when the capture raises (the probe's eager
        steps have set the carry)."""
        try:
            graphs, eager, replayed = self._capture()
        finally:
            self.reset()
        differ = [name for name, a, b in zip(
            [f"rows of probe step {i}" for i in range(len(eager) - 1)] + ["buffer"],
            eager, replayed) if not all(_same_bits(x, y) for x, y in zip(a, b))]
        if differ:
            raise RuntimeError("the captured steps differ from the eager steps in "
                               + ", ".join(differ))
        return graphs

    def _serve_from(self, aot_dir: str) -> None:
        """Serve from the graphs of this configuration's key under
        ``aot_dir``, or log why not and stay eager."""
        key = self._aot_key()
        manifests = [load_manifest(p, key) for p in _stream_executable_paths(aot_dir, key)]
        if None in manifests:
            get_logger().warning(
                "no captured-graph manifests for key %s under %s — serving eagerly "
                "(run python -m streamyolo_torch.tools.precompile --serve)", key[:20], aot_dir)
            return
        try:
            if self.device.type == "cuda":
                self._load_libraries(aot_dir, manifests[0]["libraries"])
            graphs = self._capture_probed()
        except Exception as e:  # noqa: BLE001 — any failure leaves the eager step serving
            get_logger().warning(
                "graphs of key %s under %s failed to capture or probe (%s: %s) — "
                "serving eagerly", key[:20], aot_dir, type(e).__name__, e)
            return
        self.graphs, self.aot_loaded = graphs, True
        get_logger().info("serving from captured graphs (key %s under %s; capture seconds %s)",
                          key[:20], aot_dir, graphs.capture_seconds)

    @staticmethod
    def _load_libraries(aot_dir: str, libraries: Dict[str, dict]) -> None:
        from streamyolo_torch.ops import _build

        for name, lib in libraries.items():
            path = os.path.join(aot_dir, lib["file"])
            if file_digest(path) != lib["sha256"]:
                raise RuntimeError(f"kernel library {path} differs from its manifest's")
            _build.load_from(name, path)

    def _export(self, aot_dir: str) -> Tuple[str, str]:
        """Capture and probe the steps (raising on failure), then write both
        manifests and the kernel libraries the graphs launch."""
        from streamyolo_torch.ops import _build

        graphs = self._capture_probed()
        key = self._aot_key()
        os.makedirs(aot_dir, exist_ok=True)
        libraries = {}
        used = sorted({k for captured in graphs.captured for k, n in captured.items() if n})
        for name in used:
            src = _build.library_path(name)
            dst = os.path.join(aot_dir, os.path.basename(src))
            if not (os.path.isfile(dst) and file_digest(dst) == file_digest(src)):
                shutil.copyfile(src, dst + ".tmp")
                os.replace(dst + ".tmp", dst)
            libraries[name] = {"file": os.path.basename(dst), "digest": _build.digest(name),
                               "sha256": file_digest(dst)}
        parts = dict(self._aot_config(), image_shape=list(self._image_shape()))
        paths = _stream_executable_paths(aot_dir, key)
        for graph, path, seconds, captured in zip(("star", "steady"), paths,
                                                  graphs.capture_seconds, graphs.captured):
            save_manifest({"key": key, "graph": graph, "parts": parts,
                           "environment": environment(self.device),
                           "capture_seconds": seconds, "captured_launches": captured,
                           "libraries": libraries}, path)
        get_logger().info("exported captured-graph manifests (key %s; captures %s) -> %s",
                          key[:20], graphs.capture_seconds, aot_dir)
        return paths


class CUDAStreamDetector(_GraphServing):
    """Stateful streaming detector carrying the DFP buffer across frames.

    Parse contract (as ``TPUStreamDetector``): returns
    (bboxes_ltrb / in_scale, scores, int labels, None-masks).

    ``aot_dir``: serve from the captured graphs of this configuration
    (module docstring); ``aot_loaded`` says whether it does, ``graphs``
    holds them. The graphs read the model's parameters in place: load new
    weights with ``load_state_dict`` (same tensors), never by moving the
    model.

    ``mesh`` (``parallel/spatial.py::make_spatial_mesh``), the latency
    mode: with more than one device, each frame's rows are sliced over the
    mesh (``SpatialStreamYOLO``), the model is replicated on each distinct
    device (``load_state_dict`` on ``model`` reaches every copy), and the
    DFP buffer stays sharded: each level one slab per mesh device, on it.
    The decode and NMS (kernel B1) run on ``mesh.devices[0]``, which
    replaces ``device``. As in the JAX package, the input H must divide by
    the mesh size, ``device_preproc`` is refused, and the step runs eagerly
    (``aot_dir`` is not read). With a one-device mesh the detector is the
    plain one on that device."""

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
        aot_dir: Optional[str] = None,
        mesh=None,
    ):
        if mesh is not None:
            device = mesh.devices[0]
            if mesh.size > 1:
                n = mesh.size
                if device_preproc:
                    raise ValueError(
                        "device_preproc runs kernel B2 on the whole frame, which is not "
                        "row-sharded; use the host preproc path with a spatial mesh")
                if input_size[0] % n:
                    raise ValueError(
                        f"spatial mesh of {n} devices needs input H divisible by {n}, "
                        f"got {input_size[0]}")
            else:
                mesh = None
        self.mesh = mesh
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
        if mesh is not None:
            self.spatial = SpatialStreamYOLO(self.model, mesh)
            self._step = _build_spatial_step(
                self.spatial, num_classes=num_classes, conf_thre=conf_thre,
                nms_thre=nms_thre, pre_nms_topk=pre_nms_topk,
                compute_dtype=self.compute_dtype)
            if aot_dir is not None:
                get_logger().info(
                    "spatial mesh of %d devices: serving eagerly, %s is not read",
                    mesh.size, aot_dir)
        else:
            self._step = _build_stream_step(
                self.model, num_classes=num_classes, conf_thre=conf_thre,
                nms_thre=nms_thre, pre_nms_topk=pre_nms_topk,
                compute_dtype=self.compute_dtype, device_preproc=device_preproc)
            if aot_dir is not None:
                self._serve_from(aot_dir)

    def _aot_config(self) -> dict:
        return dict(kind="stream_step", num_classes=self.num_classes,
                    conf_thre=self.conf_thre, nms_thre=self.nms_thre,
                    pre_nms_topk=self.pre_nms_topk, compute_dtype=str(self.compute_dtype),
                    device_preproc=self.device_preproc)

    def _image_shape(self) -> Tuple[int, int, int, int]:
        scale = 2 if self.device_preproc else 1
        return (1, scale * self.input_size[0], scale * self.input_size[1], 3)

    def _capture(self):
        """Static tensors shaped by an eager star step, the two graphs, and
        (eager, replayed) rows of a star and a steady probe frame and the
        buffer after them."""
        probes = self._probe_frames(2)
        self.reset()
        eager = [(self._eager_step(p).clone(),) for p in probes]
        eager.append(tuple(b.clone() for b in self._buffer))
        image, out = probes[0].clone(), eager[0][0].clone()
        buffer = tuple(b.clone() for b in self._buffer)  # clone keeps the layout
        graphs = GraphSteps(lambda: self._step(image, buffer, True, out),
                            lambda: self._step(image, buffer, False, out), self.device)
        replayed = []
        for star, probe in zip((True, False), probes):
            image.copy_(probe)
            graphs.run(star)
            replayed.append((out.clone(),))
        replayed.append(tuple(b.clone() for b in buffer))
        self._static = (image, buffer, out)
        return graphs, eager, replayed

    def reset(self):
        self._buffer = None

    def warmup(self, n: int = 10):
        """Run ``n`` frames of zeros through the star and steady steps."""
        frame = np.zeros(self._image_shape()[1:], np.uint8)
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

    def _eager_step(self, image: torch.Tensor) -> torch.Tensor:
        dets, self._buffer = self._step(image, self._buffer, self._buffer is None)
        return dets

    @torch.inference_mode()
    def step(self, image: torch.Tensor) -> torch.Tensor:
        """One device step: [1, H, W, 3] uint8 (raw [1, 2H, 2W, 3] with
        ``device_preproc``), on the host or ``self.device`` -> [1, K, 8]
        rows on the device. Updates the buffer. From graphs the rows are the
        static output tensor, overwritten by the next step."""
        if self.graphs is None:  # a spatial step copies each shard's rows itself
            return self._eager_step(image if self.mesh is not None else image.to(self.device))
        static_image, buffer, out = self._static
        _check_shape(image, static_image)
        static_image.copy_(image)
        self.graphs.run(star=self._buffer is None)
        self._buffer = buffer
        return out

    def __call__(self, frame_bgr: np.ndarray, preprocessed: bool = False):
        frame = frame_bgr if preprocessed else self.preproc(frame_bgr)
        image = torch.from_numpy(np.ascontiguousarray(frame))[None]
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


def export_stream_executables(
    model: torch.nn.Module,
    aot_dir: str,
    *,
    input_size: Tuple[int, int] = (600, 960),
    conf_thre: float = 0.01,
    nms_thre: float = 0.65,
    num_classes: int = 8,
    pre_nms_topk: int = 200,
    use_bf16: bool = True,
    device_preproc: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[str, str]:
    """Capture and probe the ``CUDAStreamDetector`` star and steady steps for
    the exact serving configuration, and write their manifests and the
    kernel libraries they launch under ``aot_dir``. A later
    ``CUDAStreamDetector(..., aot_dir=aot_dir)`` with the same configuration
    (any weights of the same shapes) captures its graphs from those
    libraries without running ``nvcc``. Raises if the capture or the probe
    fails. Returns the (star, steady) manifest paths."""
    det = CUDAStreamDetector(
        model, input_size=input_size, conf_thre=conf_thre, nms_thre=nms_thre,
        num_classes=num_classes, pre_nms_topk=pre_nms_topk, use_bf16=use_bf16,
        device_preproc=device_preproc, device=device)
    return det._export(aot_dir)


class MultiStreamDetector(_GraphServing):
    """N independent camera streams batched through ONE on_pipe step.

    The on_pipe step is row-wise independent (each batch row carries its own
    slice of the DFP buffer), so N streams cost one batched step instead of
    N single-frame steps: one H2D of [N, H, W, 3] uint8, one model pass, one
    ``postprocess_fixed`` over [N, K, 8] with ONE kernel-B1 launch of grid N
    (one block per stream), one D2H.

    Per-stream restarts (a camera drops and reconnects) use the model's
    ``star_mask``: ``reset(i)`` marks row ``i``, whose next step fuses with
    its OWN current features while the other rows keep their carry. When no
    row is marked the eager step does not pass the mask, which gives exactly
    the buffer select of an all-False mask without its three ``where``
    launches; the captured steady step always takes the mask, written to
    the card only when it changes.

    ``aot_dir``, ``aot_loaded`` and ``graphs`` as ``CUDAStreamDetector``'s.

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
        aot_dir: Optional[str] = None,
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
        self._step = _build_multi_stream_step(
            self.model, num_classes=num_classes, conf_thre=conf_thre, nms_thre=nms_thre,
            pre_nms_topk=pre_nms_topk, compute_dtype=self.compute_dtype)
        self._buffer = None
        self._pending_star = np.zeros(n_streams, bool)
        if aot_dir is not None:
            self._serve_from(aot_dir)

    def _aot_config(self) -> dict:
        return dict(kind="multi_stream_step", num_classes=self.num_classes,
                    conf_thre=self.conf_thre, nms_thre=self.nms_thre,
                    pre_nms_topk=self.pre_nms_topk, compute_dtype=str(self.compute_dtype))

    def _image_shape(self) -> Tuple[int, int, int, int]:
        return (self.n_streams, *self.input_size, 3)

    def _capture(self):
        """Static tensors shaped by an eager star step, the two graphs, and
        (eager, replayed) rows of three probe batches: the star, a steady
        step re-starring the last stream, a steady step with no restart
        (eagerly: no mask; replayed: the all-False mask), then the buffer."""
        probes = self._probe_frames(3)
        restart = np.zeros(self.n_streams, bool)
        restart[-1] = True
        self.reset()
        eager = []
        for i, p in enumerate(probes):
            self._pending_star[:] = restart if i == 1 else False
            eager.append((self._eager_step(p).clone(),))
        eager.append(tuple(b.clone() for b in self._buffer))
        images, out = probes[0].clone(), eager[0][0].clone()
        buffer = tuple(b.clone() for b in self._buffer)  # clone keeps the layout
        mask = torch.zeros(self.n_streams, dtype=torch.bool, device=self.device)
        graphs = GraphSteps(lambda: self._step(images, buffer, True, None, out),
                            lambda: self._step(images, buffer, False, mask, out), self.device)
        replayed = []
        for i, p in enumerate(probes):
            images.copy_(p)
            mask.copy_(torch.from_numpy(restart if i == 1 else np.zeros_like(restart)))
            graphs.run(star=i == 0)
            replayed.append((out.clone(),))
        replayed.append(tuple(b.clone() for b in buffer))
        mask.zero_()
        self._mask_on_card = np.zeros(self.n_streams, bool)
        self._static = (images, buffer, out, mask)
        return graphs, eager, replayed

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
        frames = np.zeros(self._image_shape(), np.uint8)
        self.reset()
        for _ in range(n):
            self(frames, preprocessed=True)
        self.reset()

    def preproc(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Per-stream host resize (``CUDAStreamDetector``'s host path)."""
        return _host_resize(frame_bgr, self.input_size)

    def _eager_step(self, images: torch.Tensor) -> torch.Tensor:
        star_mask = None
        if self._buffer is not None and self._pending_star.any():
            star_mask = torch.from_numpy(self._pending_star.copy()).to(
                self.device, non_blocking=True)
        dets, self._buffer = self._step(images, self._buffer, self._buffer is None, star_mask)
        return dets

    @torch.inference_mode()
    def step(self, images: torch.Tensor) -> torch.Tensor:
        """One batched device step: [N, H, W, 3] uint8 on the host or
        ``self.device`` -> [N, K, 8] rows on the device. Consumes the
        pending per-stream stars (a reset before the first step is absorbed
        by the all-star step) and updates the buffer in place. From graphs
        the rows are the static output tensor, overwritten by the next
        step."""
        if self.graphs is None:
            dets = self._eager_step(images.to(self.device))
        else:
            static_images, buffer, dets, mask = self._static
            _check_shape(images, static_images)
            static_images.copy_(images)
            star = self._buffer is None
            if not star and not np.array_equal(self._pending_star, self._mask_on_card):
                self._mask_on_card = self._pending_star.copy()
                mask.copy_(torch.from_numpy(self._mask_on_card))
            self.graphs.run(star)
            self._buffer = buffer
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
        images = torch.from_numpy(np.ascontiguousarray(frames))
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


def export_multi_stream_executables(
    model: torch.nn.Module,
    aot_dir: str,
    *,
    n_streams: int,
    input_size: Tuple[int, int] = (600, 960),
    conf_thre: float = 0.01,
    nms_thre: float = 0.65,
    num_classes: int = 8,
    pre_nms_topk: int = 200,
    use_bf16: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[str, str]:
    """``export_stream_executables`` for the batched N-camera step: a later
    ``MultiStreamDetector(..., aot_dir=aot_dir)`` with the same
    configuration serves from graphs without running ``nvcc``."""
    det = MultiStreamDetector(
        model, n_streams, input_size=input_size, conf_thre=conf_thre, nms_thre=nms_thre,
        num_classes=num_classes, pre_nms_topk=pre_nms_topk, use_bf16=use_bf16,
        device=device)
    return det._export(aot_dir)


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
    ``data_root/<seq_dir>/<name>`` of an image dict with cv2 (a clear
    ImportError at the first read where cv2 is absent)."""
    from streamyolo_torch.data.datasets import imread

    seq_dirs = db.dataset["seq_dirs"]

    def load(img: dict) -> np.ndarray:
        return imread(os.path.join(data_root, seq_dirs[img["sid"]], img["name"]))

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
