"""The port's frame reading and host resize without cv2
(``streamyolo_torch/data/image_io.py`` over ``native/image_io.cpp``, and
``data/cv2_ops.py::resize_u8``), against cv2 5.x and the JAX package, on
the CPU. Everything is compared for equality; there is no tolerance.

  * ``imdecode`` equals ``cv2.imdecode(buf, IMREAD_COLOR)`` for cv2-written
    files in each sampling factor (4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4) and
    grayscale, at qualities 5 / 50 / 90 / 100, sizes 1x1 to 120x161, with
    and without a restart interval and optimised Huffman tables, and for a
    1200x1920 frame; each Exif orientation as ``cv2.imread`` applies it;
    refusals name what they refuse;
  * the JAX package's frames (``make_synthetic_argoverse`` at 128x192 and
    1200x1920): ``imread`` against ``cv2.imread`` (what the JAX package
    reads with), ``TPUStreamDetector.preproc`` against the port's
    ``CUDAStreamDetector.preproc``, the JAX dataset's ``_read_resized``
    against the port's;
  * ``tests/torch_jpeg/digests.json`` holds cv2's digests of the committed
    fixtures (what ``chip_smoke.py``'s phase ``image_io`` checks on a host
    without cv2), and the port gives the same bytes;
  * a fresh interpreter in which ``import cv2`` fails reads the JAX-written
    fixture from disk through ``db_from_img_folder``, both detectors' host
    path, ``offline_det`` and ``stream_det``; its ``offline_det``
    detections equal the same run in this process;
  * the native library is built once: a spawned process loads the built
    file.
"""

import json
import multiprocessing
import os
import pickle
import struct
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from streamyolo_tpu.data import datasets as jdatasets
from streamyolo_tpu.data import dbcode as jdbcode
from streamyolo_tpu.stream import TPUStreamDetector
from streamyolo_torch import native
from streamyolo_torch.data import cv2_ops
from streamyolo_torch.data import datasets as tdatasets
from streamyolo_torch.data.image_io import image_size, imdecode, imread
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.stream import CUDAStreamDetector
from tests.torch_png import chunk

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_jpeg"
SAMPLINGS = {"411": 0x411111, "420": 0x221111, "422": 0x211111, "440": 0x121111,
             "444": 0x111111, "gray": None}
SIZES = ((1, 1), (2, 3), (17, 9), (37, 53), (120, 161))
SMALL_CONFIG = """
from streamyolo_torch.cfgs.s_s50_onex_dfp_tal_flip import Exp as Base


class Exp(Base):
    def __init__(self):
        super().__init__()
        self.width = 0.25
"""


def encode(img, **params) -> bytes:
    flags = [cv2.IMWRITE_JPEG_QUALITY, params.get("quality", 90)]
    if params.get("sampling") is not None:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, params["sampling"]]
    for key, flag in (("restart", cv2.IMWRITE_JPEG_RST_INTERVAL),
                      ("optimize", cv2.IMWRITE_JPEG_OPTIMIZE),
                      ("progressive", cv2.IMWRITE_JPEG_PROGRESSIVE)):
        if params.get(key):
            flags += [flag, int(params[key])]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def cv2_decode(buf: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


def textured(rng, h, w):
    """Gradients, a hard colour edge and noise: every block has AC energy."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 7 + y * 3, x * 2 + y * 5 + 40, (x - y) * 4], -1) % 256
    img[h // 3:, w // 2:] = (30, 220, 250)
    return np.clip(img + rng.integers(-25, 26, (h, w, 3)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- decoder


@pytest.mark.parametrize("quality", [5, 50, 90, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_decoder_equals_cv2(sampling, quality):
    """Every size, restart interval on and off, optimised tables on and off,
    on a textured image and on uniform noise."""
    rng = np.random.default_rng(quality)
    sf = SAMPLINGS[sampling]
    for h, w in SIZES:
        for img in (textured(rng, h, w), rng.integers(0, 256, (h, w, 3), np.uint8)):
            if sf is None:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            for restart in (0, 2):
                for optimize in (0, 1):
                    buf = encode(img, quality=quality, sampling=sf, restart=restart,
                                 optimize=optimize)
                    want = cv2_decode(buf)
                    got = imdecode(buf)
                    assert got.dtype == np.uint8 and got.shape == want.shape
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{h}x{w} restart={restart} optimize={optimize}")


def test_full_frame_equals_cv2():
    """A 1200x1920 frame of the JAX generator (baseline 4:2:0, quality 90),
    and the same file without its DHT segments (libjpeg's standard tables)."""
    path = FIXTURES / "frames" / "seq00" / "000000.jpg"
    want = cv2.imread(str(path))
    np.testing.assert_array_equal(imread(path), want)
    no_dht = (FIXTURES / "small" / "no_dht_37x53.jpg").read_bytes()
    assert b"\xff\xc4" not in no_dht[:no_dht.index(b"\xff\xda")]
    np.testing.assert_array_equal(imdecode(no_dht), cv2_decode(no_dht))


def with_orientation(buf: bytes, orientation: int, big_endian: bool) -> bytes:
    e = ">" if big_endian else "<"
    tiff = ((b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    seg = b"Exif\x00\x00" + tiff
    return buf[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + buf[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(tmp_path, orientation):
    """cv2 applies the Exif Orientation tag (both ``imread`` and
    ``imdecode``); so do ``imdecode``, ``imread`` and ``image_size``."""
    img = textured(np.random.default_rng(orientation), 37, 53)
    for big_endian in (False, True):
        buf = with_orientation(encode(img), orientation, big_endian)
        path = tmp_path / f"o{orientation}.jpg"
        path.write_bytes(buf)
        want = cv2.imread(str(path))
        np.testing.assert_array_equal(imdecode(buf), cv2_decode(buf))
        np.testing.assert_array_equal(imread(path), want)
        assert image_size(path) == want.shape[:2]


def with_frame_marker(buf: bytes, marker: int) -> bytes:
    """``buf`` with its frame header's marker (SOF0 / SOF2) replaced: the
    header of a frame type the decoder does not read."""
    p = max(buf.find(b"\xff\xc0"), buf.find(b"\xff\xc2"))
    return buf[:p + 1] + bytes([marker]) + buf[p + 2:]


def apng(png: bytes) -> bytes:
    """``png`` with an acTL chunk after its IHDR: an animated PNG."""
    return png[:33] + chunk(b"acTL", struct.pack(">II", 1, 0)) + png[33:]


@pytest.mark.parametrize("case", ["progressive", "lossless", "png", "truncated", "empty"])
def test_refusals_name_what_they_refuse(tmp_path, case):
    """Outside the decoders (a hierarchical progressive JPEG, a lossless
    JFIF (YCbCr) one, an animated PNG), or corrupt:
    ``OSError`` with a reason (and, from ``imread``, the path). Truncated
    entropy-coded data raises where libjpeg would warn and fill with zeros
    (a deliberate divergence; cv2 5.0 returns None for it)."""
    img = textured(np.random.default_rng(0), 64, 80)
    data, reason = {
        "progressive": (with_frame_marker(encode(img, progressive=1), 0xC6),
                        "hierarchical JPEG \\(SOF6\\)"),
        "lossless": (with_frame_marker(encode(img), 0xC3), "lossless YCbCr JPEG"),
        "png": (apng(cv2.imencode(".png", img)[1].tobytes()), "animated PNG"),
        "truncated": (encode(img)[:900], "premature end"),
        "empty": (b"", "empty file"),
    }[case]
    with pytest.raises(OSError, match=reason):
        imdecode(data)
    path = tmp_path / "frame.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError, match="frame.jpg"):
        imread(path)


def damaged(case: str) -> bytes:
    buf = (FIXTURES / "small" / "restart_120x161.jpg").read_bytes()
    sos = buf.index(b"\xff\xda")
    rst = buf.index(b"\xff\xd1", sos)
    return {
        "bytes before EOI": buf[:-2] + b"\x12\x34" + buf[-2:],
        "fill bytes before EOI": buf[:-2] + b"\xff\xff\xff" + buf[-2:],
        "bytes after EOI": buf + b"\x12\x34\x56",
        "bytes before a restart marker": buf[:rst] + b"\x00" + buf[rst:],
        "bytes between header segments": buf[:2] + b"\x00\x11" + buf[2:],
        "no EOI": buf[:-2],
        "wrong restart marker": buf[:rst] + b"\xff\xd5" + buf[rst + 2:],
        "a second scan": buf[:-2] + buf[sos:],
        "scan parameters not sequential": buf[:sos + 11] + b"\x00\x00\x01" + buf[sos + 14:],
    }[case]


@pytest.mark.parametrize("case,cv2_reads,port_reads", [
    ("bytes before EOI", True, True), ("fill bytes before EOI", True, True),
    ("bytes after EOI", True, True), ("bytes before a restart marker", True, True),
    ("bytes between header segments", False, False), ("no EOI", False, False),
    # libjpeg has output the one-scan image before it meets the second SOS
    ("a second scan", True, True),
    # Ss, Se, Ah, Al of 0, 0, 0, 1 in a one-scan file: a warning in libjpeg
    ("scan parameters not sequential", True, True),
    # a deliberate divergence: libjpeg resynchronises
    ("wrong restart marker", True, False),
])
def test_damaged_files_as_cv2_or_refused(case, cv2_reads, port_reads):
    """Where cv2 reads a damaged file the port gives the same image, where
    cv2 gives None the port raises; one case where cv2 returns an image is
    refused (ROADMAP C)."""
    data = damaged(case)
    want = cv2_decode(data)
    assert (want is not None) == cv2_reads
    if port_reads:
        np.testing.assert_array_equal(imdecode(data), want)
    else:
        with pytest.raises(OSError, match="corrupt JPEG data"):
            imdecode(data)


# ---------------------------------------------------------------- the JAX package


@pytest.fixture(scope="module", params=[(128, 192), (1200, 1920)], ids=["128x192", "1200x1920"])
def jax_frames(request, tmp_path_factory):
    """One sequence of 2 frames written by the JAX package's generator."""
    root = tmp_path_factory.mktemp("jax_frames")
    jdbcode.make_synthetic_argoverse(str(root), seq_lens=(2,), size=request.param, seed=0)
    return root, request.param


def test_reads_and_resizes_equal_the_jax_package(jax_frames):
    root, (h, w) = jax_frames
    seq = root / "Argoverse-1.1" / "tracking" / "seq00"
    paths = sorted(seq.glob("*.jpg"))
    frames = [imread(p) for p in paths]
    for p, f in zip(paths, frames):
        np.testing.assert_array_equal(f, cv2.imread(str(p)))
    # the detectors' host path: the exact 2x average and the general path
    model = StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25))
    for size in ((h // 2, w // 2), (h // 2 + 1, w // 2 - 1), (h // 3, w // 3)):
        port = CUDAStreamDetector(model, input_size=size, device="cpu", use_bf16=False)
        ref = types.SimpleNamespace(device_preproc=False, input_size=size)
        for f in frames:
            np.testing.assert_array_equal(port.preproc(f), TPUStreamDetector.preproc(ref, f))
    # the datasets' frame read + letterbox resize
    for img_size in ((h // 2, w // 2), (int(h * 0.8), w)):
        jds = jdatasets.ONE_ARGOVERSEDataset(str(root), "val.json", name="val",
                                             img_size=img_size)
        tds = tdatasets.ONE_ARGOVERSEDataset(str(root), "val.json", name="val",
                                             img_size=img_size)
        for im_ann in tds.coco.dataset["images"]:
            np.testing.assert_array_equal(tds._read_resized(im_ann),
                                          jds._read_resized(tds._file_name(im_ann)))


# ---------------------------------------------------------------- fixtures


def digest(arr) -> dict:
    import hashlib

    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_fixture_digests_are_cv2s():
    """``digests.json`` is cv2's reading of every committed fixture (and of
    its resizes of the frames), and the port reads the same bytes: 23
    baseline JPEGs, under ``progressive/`` 25 progressive and multi-scan
    ones, and under ``codings/`` 52 arithmetic-coded, lossless, CMYK, YCCK
    and RGB-coded ones."""
    with open(FIXTURES / "digests.json") as f:
        digests = json.load(f)
    files = sorted(p.relative_to(FIXTURES).as_posix() for p in FIXTURES.glob("*/**/*.jpg"))
    assert files == sorted(digests["decode"]) and len(files) == 23 + 25 + 52
    for rel in files:
        want = cv2.imread(str(FIXTURES / rel))
        assert digest(want) == digests["decode"][rel], rel
        got = imread(FIXTURES / rel)
        assert digest(got) == digests["decode"][rel], rel
        assert image_size(FIXTURES / rel) == want.shape[:2], rel
        for key, d in digests["resize"].get(rel, {}).items():
            oh, ow = map(int, key.split("x"))
            assert digest(cv2.resize(want, (ow, oh), interpolation=cv2.INTER_LINEAR)) == d
            assert digest(cv2_ops.resize_u8(got, oh, ow)) == d, (rel, key)
    assert {rel for rel in files if rel.startswith("frames/")} == set(digests["resize"])


# ---------------------------------------------------------------- without cv2


NO_CV2_CHILD = """
import json, os, pickle, sys
sys.modules["cv2"] = None  # any import of cv2 raises ImportError
import numpy as np
import torch
from streamyolo_torch.data import db_from_img_folder, imread
from streamyolo_torch.exp import get_exp
from streamyolo_torch.stream import CUDAStreamDetector, MultiStreamDetector
from streamyolo_torch.tools import offline_det, stream_det

data_root, annot, config, weights, zoo, out = sys.argv[1:7]
db = db_from_img_folder(data_root, out_path=os.path.join(out, "folder.json"))
want = json.load(open(annot))
assert [(i["name"], i["height"], i["width"]) for i in db["images"]] == \\
    [(i["name"], i["height"], i["width"]) for i in want["images"]]
common = ["--data-root", data_root, "-f", config, "-c", weights, "--fp32", "--device", "cpu"]
off = offline_det.main([*common, "--annot-path", annot, "--out-dir",
                        os.path.join(out, "off"), "--no-eval"])
ti = stream_det.main([*common, "--annot-path", os.path.join(out, "folder.json"),
                      "--out-dir", os.path.join(out, "stream"), "--overwrite",
                      "--sim-zoo", zoo, "--sim-name", "fixed"])
frame = imread(os.path.join(data_root, db["seq_dirs"][0], db["images"][0]["name"]))
model = get_exp(config).get_model("cpu", dtype=torch.float32)
h, w = frame.shape[0] // 2, frame.shape[1] // 2
single = CUDAStreamDetector(model, input_size=(h, w), device="cpu", use_bf16=False)
multi = MultiStreamDetector(model, 2, input_size=(h, w), device="cpu", use_bf16=False)
single(frame)
multi([frame, frame[:, ::-1]])
assert sys.modules["cv2"] is None
print(json.dumps({"detections": len(off["results_ccf"]), "processed": ti["n_processed"],
                  "seqs": sorted(os.listdir(os.path.join(out, "stream")))}))
"""


def test_port_reads_from_disk_without_cv2(tmp_path):
    """StreamYOLO-s at width 0.25 on a JAX-written 2 x 4-frame fixture,
    ``--device cpu``, in a child where cv2 cannot be imported; ``stream_det``
    under a simulated clock with a fixed 20 ms latency (every frame served,
    whatever the host's load)."""
    import streamyolo_torch.tools.offline_det as t_offline_det
    from streamyolo_torch.exp import get_exp

    jdbcode.make_synthetic_argoverse(str(tmp_path / "data"), seq_lens=(4, 4), size=(128, 192),
                                     seed=0)
    data_root = str(tmp_path / "data" / "Argoverse-1.1" / "tracking")
    annot = str(tmp_path / "data" / "Argoverse-HD" / "annotations" / "val.json")
    config = tmp_path / "s_width025.py"
    config.write_text(SMALL_CONFIG)
    state = get_exp(str(config)).init_model()
    for k in state:  # obj/cls prediction biases 0: NMS sees candidates
        if k.startswith(("head.obj_preds.", "head.cls_preds.")) and k.endswith(".bias"):
            state[k] = torch.zeros_like(state[k])
    weights = str(tmp_path / "w.pth")
    torch.save(state, weights)
    zoo = str(tmp_path / "zoo.pkl")
    with open(zoo, "wb") as f:
        pickle.dump({"fixed": {"type": "empirical", "samples": [0.02]}}, f)
    out = tmp_path / "child"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", NO_CV2_CHILD, data_root, annot, str(config), weights, zoo,
         str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child["seqs"] == ["seq00.pkl", "seq01.pkl", "time_info.pkl"]
    assert child["processed"] == 8 and child["detections"] > 0
    t_offline_det.main(["--data-root", data_root, "--annot-path", annot, "-f", str(config),
                        "-c", weights, "--fp32", "--device", "cpu", "--no-eval",
                        "--out-dir", str(tmp_path / "in_process")])
    with open(out / "off" / "results_ccf.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "in_process" / "results_ccf.pkl", "rb") as f:
        want = pickle.load(f)
    assert len(got) == child["detections"] and got == want


# ---------------------------------------------------------------- the build


def _loaded_library() -> str:
    """In a spawned process: the resize runs, and the library it loaded."""
    from streamyolo_torch import native as n
    from streamyolo_torch.data.cv2_ops import resize_u8

    resize_u8(np.zeros((4, 6, 3), np.uint8), 3, 5)
    return n._libs[n.IMAGE_IO_SOURCE]._name


def test_spawned_process_loads_the_built_library():
    """The library is built once, under ``build/native/``; a spawned worker
    (a loader's) loads that file and does not build it again."""
    native.load_image_io()
    path = native._target(native.IMAGE_IO_SOURCE, native.IMAGE_IO_FLAGS)
    assert path.exists() and path.parent == native.BUILD_DIR
    before = path.stat().st_mtime_ns
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        assert pool.apply(_loaded_library) == str(path)
    assert path.stat().st_mtime_ns == before
