"""Card tests of the real-time CLI and the Streamer (marked ``cuda``; they
skip on a host without a GPU). This file imports neither flax nor the JAX
package, so it runs on the card's machine:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stream_cli_cuda.py -m cuda

``stream_det`` with ``--device-preproc`` on in-memory frames (the card's
machine has no cv2): StreamYOLO-s with seeded weights, obj/cls prediction
biases 0, 2 x 8 raw 256x384 synthetic frames (128x192 input), under a
simulated clock with one fixed latency and under the wall clock. Each
detector call launches kernel B2 then B1 once; ``stream_det`` warms up
``WARMUP_FRAMES`` frames first, and a call whose result lands past a
sequence's horizon is made but not recorded. Then a ``Streamer`` whose
child builds a CUDA detector.
"""

import json
import pickle

import pytest
import torch

from streamyolo_torch.data import SyntheticArgoverse
from streamyolo_torch.exp import get_exp
from streamyolo_torch.ops.nms_cuda import nms_keep
from streamyolo_torch.ops.preproc import downsample2x
from streamyolo_torch.stream import Streamer
from streamyolo_torch.tools import stream_det

from .torch_port_helpers import make_cuda_detector, require_cuda

CONFIG = "cfgs/s_s50_onex_dfp_tal_flip.py"


@pytest.fixture
def cli_fixture(tmp_path):
    synth = SyntheticArgoverse(seq_lens=(8, 8), size=(256, 384), seed=0)
    annot = tmp_path / "val.json"
    annot.write_text(json.dumps(synth.data))
    state = get_exp(CONFIG).init_model()
    for k in state:
        if k.startswith(("head.obj_preds.", "head.cls_preds.")) and k.endswith(".bias"):
            state[k] = torch.zeros_like(state[k])
    torch.save(state, tmp_path / "w.pth")
    with open(tmp_path / "zoo.pkl", "wb") as f:
        pickle.dump({"fixed": {"type": "empirical", "samples": [0.02]}}, f)
    argv = ["--data-root", str(tmp_path), "--annot-path", str(annot), "-f", CONFIG,
            "-c", str(tmp_path / "w.pth"), "--device-preproc", "--overwrite"]
    return synth, argv, tmp_path


@pytest.mark.cuda
@pytest.mark.parametrize("clock", ["sim", "wall"])
def test_stream_det_device_preproc_launch_counts(cli_fixture, clock):
    require_cuda()
    synth, argv, tmp = cli_fixture
    extra = ["--sim-zoo", str(tmp / "zoo.pkl"), "--sim-name", "fixed"] if clock == "sim" else []
    nms_keep.launches = 0
    downsample2x.launches = 0
    info = stream_det.main([*argv, "--out-dir", str(tmp / clock), *extra],
                           load_frame=synth.frame)
    calls = nms_keep.launches - stream_det.WARMUP_FRAMES
    assert nms_keep.launches == downsample2x.launches
    assert info["n_total"] == 16 and 0 < info["n_processed"] <= calls <= info["n_processed"] + 2
    if clock == "sim":  # 20 ms < one frame: every frame, one result per call
        assert info["n_processed"] == calls == 16
    for seq in ("seq00", "seq01"):
        with open(tmp / clock / f"{seq}.pkl", "rb") as f:
            ts = pickle.load(f)["timestamps"]
        assert all(b > a for a, b in zip(ts, ts[1:])) and ts[-1] < 8 / 30


@pytest.mark.cuda
def test_streamer_child_builds_a_cuda_detector():
    require_cuda()
    synth = SyntheticArgoverse(seq_lens=(3,), size=(256, 384), seed=1)
    with Streamer(make_cuda_detector) as s:
        for fidx, img in enumerate(synth.data["images"]):
            assert s.submit(fidx, synth.frame(img), fidx / 30.0)
            back = None
            for _ in range(600):
                back = s.poll(timeout=0.1)
                if back is not None:
                    break
            assert back == fidx
        assert s.last_result[3] == (3, 3)  # B1 and B2 once per frame, in the child
        boxes, scores, labels, tracks = s.forecast(3 / 30.0, 384, 256)
        assert boxes.shape == (len(scores), 4) and len(labels) == len(tracks) == len(scores)
