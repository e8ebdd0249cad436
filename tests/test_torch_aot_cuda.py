"""Card tests of serving from captured CUDA graphs (marked ``cuda``; they
skip on a host without a GPU). This file imports neither flax nor the JAX
package, so it runs on the card's machine:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_aot_cuda.py -m cuda

A tiny StreamYOLO (depth 0.33, width 0.25, 64x96, seeded weights, obj/cls
prediction biases 0) exports its graphs to a directory and a detector with
``aot_dir`` serves from them: its rows equal an eager detector's bit for
bit over a chain with a restart, for one stream in float32 and bf16, with
``device_preproc`` (kernel B2 inside the graphs), int8 (the int8 conv
inside the graphs) and N = 3 streams. A fresh serving process whose
``ops/_build.py`` has no build directory and no ``nvcc`` loads the kernels
from the directory and reports ``aot_loaded``; a key miss is logged.
"""

import logging
import os

import numpy as np
import pytest
import torch

from streamyolo_torch.ops.int8_conv import int8_conv
from streamyolo_torch.ops.nms_cuda import nms_keep
from streamyolo_torch.ops.preproc import downsample2x
from streamyolo_torch.quant import quantize_for_serving
from streamyolo_torch.stream import (CUDAStreamDetector, MultiStreamDetector,
                                     export_multi_stream_executables, export_stream_executables)

from . import _torch_aot_child as child
from .torch_port_helpers import require_cuda, tiny_model

INPUT = (64, 96)
KW = dict(input_size=INPUT, in_scale=0.5, conf_thre=0.01, nms_thre=0.65, num_classes=8,
          pre_nms_topk=100)


def frames_of(seed, shape, steps):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, shape, np.uint8) for _ in range(steps)]


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def int8_tiny(dtype):
    """``tiny_model`` quantized by the port (calibrated on two frames), on
    the card."""
    model = tiny_model(torch.float32).cpu()
    batches = [np.random.RandomState(s).randint(0, 256, (1, *INPUT, 6)).astype(np.float32)
               for s in range(2)]
    q = quantize_for_serving(model, model.state_dict(), batches)
    model.load_state_dict(q, strict=True)
    return model.to(device="cuda", dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "device_preproc", "int8"])
def test_graph_rows_equal_eager_rows(kind, tmp_path):
    """Seven frames with ``reset()`` before the fifth: graph rows equal eager
    rows bit for bit, and the kernels the path runs were captured into both
    graphs (B1 always, B2 with ``device_preproc``, the int8 conv per conv
    call)."""
    require_cuda()
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    model = int8_tiny(dtype) if kind == "int8" else tiny_model(dtype)
    kw = dict(KW, use_bf16=dtype == torch.bfloat16, device_preproc=kind == "device_preproc")
    export_stream_executables(model, str(tmp_path), **{k: v for k, v in kw.items()
                                                        if k != "in_scale"})
    graph = CUDAStreamDetector(model, aot_dir=str(tmp_path), **kw)
    eager = CUDAStreamDetector(model, **kw)
    assert graph.aot_loaded
    scale = 2 if kind == "device_preproc" else 1
    frames = frames_of(1, (scale * INPUT[0], scale * INPUT[1], 3), 7)
    before = (nms_keep.launches, downsample2x.launches, int8_conv.launches)
    rows = []
    for i, frame in enumerate(frames):
        if i == 4:
            graph.reset()
            eager.reset()
        graph(frame, preprocessed=True)
        eager(frame, preprocessed=True)
        assert same_bits(graph.last_rows, eager.last_rows), i
        rows.append(graph.last_rows)
    assert (np.stack(rows)[..., 7] > 0.5).sum() > 0
    star, steady = graph.graphs.captured
    assert star == steady and steady["nms"] == 1
    assert steady["preproc"] == int(kind == "device_preproc")
    assert (steady["int8_conv"] > 0) == (kind == "int8")
    # a replay moves no counter: only the eager detector's launches count
    after = (nms_keep.launches, downsample2x.launches, int8_conv.launches)
    assert [a - b for a, b in zip(after, before)] == [
        7 * steady[k] for k in ("nms", "preproc", "int8_conv")]
    assert graph.graphs.replays == [1 + 2, 1 + 5]  # the probe, then the chain
    assert graph.graphs.launches() == {k: 3 * star[k] + 6 * steady[k] for k in steady}


@pytest.mark.cuda
def test_multi_stream_graph_rows_equal_eager_rows(tmp_path):
    """N = 3, bf16, six steps with ``reset(1)`` before the fourth: graph rows
    (the steady graph always takes the mask) equal eager rows bit for bit."""
    require_cuda()
    model = tiny_model(torch.bfloat16)
    export_multi_stream_executables(model, str(tmp_path), n_streams=3, use_bf16=True,
                                    **{k: v for k, v in KW.items() if k != "in_scale"})
    graph = MultiStreamDetector(model, 3, aot_dir=str(tmp_path), use_bf16=True, **KW)
    eager = MultiStreamDetector(model, 3, use_bf16=True, **KW)
    assert graph.aot_loaded
    for i, batch in enumerate(frames_of(2, (3, *INPUT, 3), 6)):
        if i == 3:
            graph.reset(1)
            eager.reset(1)
        graph(batch, preprocessed=True)
        eager(batch, preprocessed=True)
        assert same_bits(graph.last_rows, eager.last_rows), i
    assert graph.graphs.replays == [1 + 1, 2 + 5]


@pytest.mark.cuda
def test_serving_process_without_nvcc_loads_kernels_from_aot_dir(tmp_path):
    """Export in one fresh process (bf16, ``device_preproc`` and N = 3),
    serve in another whose ``ops/_build.py`` has neither a build directory
    nor ``nvcc``: it loads B1 and B2 from the directory, reports ``aot_loaded``,
    and its rows equal the exporting process's eager rows bit for bit."""
    require_cuda()
    model = tiny_model(torch.bfloat16).cpu()
    frames = frames_of(3, (2 * INPUT[0], 2 * INPUT[1], 3), 7)
    multi_frames = frames_of(4, (child.MULTI_N, *INPUT, 3), 6)
    torch.save({"state_dict": model.state_dict(), "kw": dict(KW, use_bf16=True),
                "device": "cuda", "dtype": torch.bfloat16, "device_preproc": True,
                "frames": frames, "multi_frames": multi_frames}, tmp_path / "setup.pt")
    child.run("export", tmp_path)
    libs = sorted(p.split("-")[0] for p in os.listdir(tmp_path) if p.endswith(".so"))
    assert libs == ["nms", "preproc"]
    child.run("serve", tmp_path, "--poison-nvcc")
    want, got = np.load(tmp_path / "want.npz"), np.load(tmp_path / "got.npz")
    for name in ("rows", "mrows"):
        assert same_bits(got[name], want[name]), name


@pytest.mark.cuda
def test_miss_is_logged(tmp_path, caplog):
    require_cuda()
    model = tiny_model(torch.bfloat16)
    export_stream_executables(model, str(tmp_path), use_bf16=True,
                              **{k: v for k, v in KW.items() if k != "in_scale"})
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        det = CUDAStreamDetector(model, aot_dir=str(tmp_path), use_bf16=True,
                                 **{**KW, "nms_thre": 0.5})
    assert not det.aot_loaded and det.graphs is None
    assert any("no captured-graph manifests" in r.message for r in caplog.records)
