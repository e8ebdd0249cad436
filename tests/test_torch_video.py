"""The port's MP4 writer (``streamyolo_torch/vis/video.py`` over
``native/video.cpp``) against cv2 5.0's ``mp4v`` writer, which the JAX
package's ``make_video`` calls, on the CPU.

FFmpeg's bytes cannot be matched (its rate control and motion search are
its own), so each file is held to what cv2 reads back from it:

  * read-back: for every sequence of ``tests/torch_video/fixture.py``
    (240x384 x 26 frames, 121x161 x 5, 29.97 fps, and ``vis_results
    --video`` on the 1200x1920 overlay fixture), written by the port in a
    child without cv2, ``cv2.VideoCapture`` finds the JAX file's frame
    count, shape and ``CAP_PROP_FPS``; a mean PSNR against the source
    (cropped to even) no lower than the JAX file's less 0.5 dB, every frame
    no lower than the JAX file's same frame less 1.0 dB, and no more than
    1.3x its bytes;
  * the decoder: FFmpeg's luma of every frame equals the encoder's own
    reconstruction, so nothing drifts across a GOP (sizes with a partial
    last macroblock row and column among them);
  * the container and stream: the box tree, ``esds``, the VOL, the GOP
    (``stss`` 1, 13, 25; I then P x 11), quantiser 3, f_code 1, the
    rounding_type sequence, and the time base against cv2's files at
    several frame rates;
  * the numeric stages: the NumPy twins of ``vis/video.py`` equal the
    native ones bit for bit;
  * the bytes: the child's files equal ``tests/torch_video/digests.json``,
    which ``chip_smoke.py`` holds the card's host to.
"""

import ctypes
import hashlib
import json
import os

import numpy as np
import pytest

from streamyolo_torch.native import load_video
from streamyolo_torch.vis import video
from tests import torch_mp4
from tests.torch_video import fixture

cv2 = pytest.importorskip("cv2")

PSNR_MEAN_SLACK, PSNR_FRAME_SLACK, BYTES_RATIO = 0.5, 1.0, 1.3


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    """The port's videos, written in a child that cannot import cv2."""
    out = tmp_path_factory.mktemp("port_video")
    report = fixture.run_port_child(out)
    assert report["cv2_loaded"] is False
    return out, report


def inputs(out, name):
    """(frame paths, fps) of a video of the fixture."""
    if name == "vis_results_plain":
        return fixture.tool_frames(out), 30.0
    return fixture.write_frames(out)[name]


def read_back(path):
    """Frames, ``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT`` cv2 reads."""
    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened(), path
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames, fps, count


@pytest.mark.parametrize("name", fixture.VIDEOS)
def test_read_back_within_bounds_of_jax_file(port_side, tmp_path, name):
    from streamyolo_tpu import vis as jvis

    out, _ = port_side
    paths, fps = inputs(out, name)
    jax_file = jvis.make_video(paths, str(tmp_path / "jax.mp4"), fps=fps)
    port_file = fixture.video_path(out, name)
    sources = [cv2.imread(p) for p in paths]
    got = {}
    for who, path in (("jax", jax_file), ("port", port_file)):
        frames, got_fps, count = read_back(path)
        assert len(frames) == len(sources) == count, (who, len(frames), count)
        h, w = frames[0].shape[:2]
        psnr = np.array([cv2.PSNR(s[:h, :w], f) for s, f in zip(sources, frames)])
        got[who] = dict(shape=frames[0].shape, fps=got_fps, psnr=psnr,
                        bytes=os.path.getsize(path))
    jax, port = got["jax"], got["port"]
    print(f"{name}: frames {len(sources)} {port['shape']} fps {port['fps']}; "
          f"mean PSNR port {port['psnr'].mean():.3f} jax {jax['psnr'].mean():.3f} dB; worst "
          f"frame gap {(port['psnr'] - jax['psnr']).min():+.3f} dB; bytes port {port['bytes']} "
          f"jax {jax['bytes']} ({port['bytes'] / jax['bytes']:.4f}x)")
    assert port["shape"] == jax["shape"] and port["fps"] == jax["fps"] == pytest.approx(fps)
    assert port["psnr"].mean() >= jax["psnr"].mean() - PSNR_MEAN_SLACK
    assert np.all(port["psnr"] >= jax["psnr"] - PSNR_FRAME_SLACK), port["psnr"] - jax["psnr"]
    assert port["bytes"] <= BYTES_RATIO * jax["bytes"]


def test_bytes_equal_pinned_digests_without_cv2(port_side):
    _, report = port_side
    assert report["videos"] == json.loads(fixture.DIGESTS.read_text())


def edge_frames(h, w, n=14):
    """A smooth texture moving down and right across n frames cut to h x w:
    vectors that reach past a partial last macroblock row and column."""
    rng = np.random.default_rng(h * w)
    texture = fixture._box_blur(rng.integers(0, 256, (h + 80, w + 80, 3)), 9).astype(np.uint8)
    return [np.ascontiguousarray(np.roll(texture, (3 * i, 5 * i), axis=(0, 1))[:h, :w])
            for i in range(n)]


@pytest.mark.parametrize("name", ["synthetic", "odd", "34x250", "18x18"])
def test_decoder_shows_the_encoders_reconstruction(tmp_path, name):
    """FFmpeg's luma (cv2 without the BGR conversion) equals the encoder's
    reference frame after every frame: the IDCT, the inverse quantiser,
    the half-pel prediction and the edge padding (of whole macroblocks,
    past a size that is not a multiple of 16) are the decoder's."""
    if name in fixture.SEQUENCES:
        frames = fixture.make_frames(name)
    else:
        frames = edge_frames(*(int(v) for v in name.split("x")))
    path = tmp_path / "v.mp4"
    recon = []
    with video.VideoWriter(str(path), 30.0, frames[0].shape[1::-1]) as writer:
        for frame in frames:
            writer.write(frame)
            recon.append(writer.reconstruction())
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)  # FFmpeg's yuv420p as its luma plane
    for i, (y, _, _) in enumerate(recon):
        ok, luma = cap.read()
        assert ok and luma.shape == y.shape, (i, luma.shape if ok else None)
        assert np.array_equal(luma, y), f"frame {i}: {np.count_nonzero(luma != y)} samples differ"
    assert not cap.read()[0]
    # chroma: cv2's BGR against the reconstruction through BT.601 with each
    # chroma sample over its 2x2 block (swscale's rounding differs by <= 3)
    cap = cv2.VideoCapture(str(path))
    for i, (y, u, v) in enumerate(recon):
        ok, bgr = cap.read()
        uu, vv = (np.repeat(np.repeat(c.astype(np.float64) - 128, 2, 0), 2, 1) * 255 / 224
                  for c in (u, v))
        yy = (y - 16.0) * 255 / 219
        want = np.stack([yy + 1.772 * uu, yy - 0.344136 * uu - 0.714136 * vv, yy + 1.402 * vv],
                        axis=-1)
        gap = np.abs(bgr - np.clip(np.round(want), 0, 255)).max()
        assert gap <= 3, f"frame {i}: BGR {gap} levels from the reconstruction"


def test_bytes_do_not_depend_on_the_thread_count(tmp_path):
    """Macroblock rows are analysed and written on threads: 1, 3 and 8 of
    them write the same file (the card's host may have another count)."""
    lib = load_video()
    frames = fixture.make_frames("odd")
    data = []
    for threads in (1, 3, 8):
        path = str(tmp_path / f"{threads}.mp4").encode()
        err = ctypes.create_string_buffer(256)
        handle = lib.video_open(path, 161, 121, 30, 1, threads, err, 256)
        assert handle, err.value
        for frame in frames:
            assert lib.video_write(handle, np.ascontiguousarray(frame), 121, 161, err, 256) == 0
        assert lib.video_close(handle, err, 256) == 0
        data.append((tmp_path / f"{threads}.mp4").read_bytes())
    assert data[0] == data[1] == data[2]
    assert hashlib.sha256(data[0]).hexdigest() == json.loads(fixture.DIGESTS.read_text())["odd"]


def test_container_and_stream_headers(port_side):
    out, _ = port_side
    data = fixture.video_path(out, "synthetic").read_bytes()
    (h, w), n, _, _ = fixture.SEQUENCES["synthetic"]
    table = torch_mp4.sample_table(data)
    names = [name for name, _, _ in table["tree"]]
    assert [x for x in names if "/" not in x] == ["ftyp", "free", "mdat", "moov"]
    stbl = "moov/trak/mdia/minf/stbl"
    for box in ("moov/mvhd", "moov/trak/tkhd", "moov/trak/mdia/mdhd", "moov/trak/mdia/hdlr",
                "moov/trak/mdia/minf/vmhd", "moov/trak/mdia/minf/dinf/dref",
                f"{stbl}/stsd/mp4v/esds", f"{stbl}/stts", f"{stbl}/stss", f"{stbl}/stsc",
                f"{stbl}/stsz", f"{stbl}/stco"):
        assert box in names, box
    assert torch_mp4.box(table["tree"], "moov/trak/mdia/hdlr")[8:12] == b"vide"
    tkhd = torch_mp4.box(table["tree"], "moov/trak/tkhd")
    assert np.frombuffer(tkhd[76:84], ">u4").tolist() == [w << 16, h << 16]
    esds = torch_mp4.esds_info(torch_mp4.box(table["tree"], f"{stbl}/stsd/mp4v/esds"))
    assert (esds["object_type"], esds["stream_type"]) == (0x20, 4)
    vol = torch_mp4.parse_headers(esds["dsi"])
    assert vol["user_data"] == []
    assert {k: vol[k] for k in ("profile_and_level", "visual_object_type", "video_object_type",
                                "width", "height", "time_resolution", "quant_type", "low_delay",
                                "interlaced", "resync_marker_disable", "data_partitioned",
                                "sprite_enable", "shape")} == dict(
        profile_and_level=1, visual_object_type=1, video_object_type=1, width=w, height=h,
        time_resolution=30, quant_type=0, low_delay=1, interlaced=0, resync_marker_disable=1,
        data_partitioned=0, sprite_enable=0, shape=0)
    assert table["stts"] == [(n, 512)]  # 30 fps on a 15360 timescale
    assert table["stss"] == [1, 13, 25]
    assert sum(table["stsz"]) == table["mdat_size"]
    start, end = table["mdat_offset"], table["mdat_offset"] + table["mdat_size"]
    assert all(start <= o and o + s <= end for o, s in zip(table["offsets"], table["stsz"]))
    vops = [torch_mp4.parse_vop(s, vol) for s in table["samples"]]
    assert "".join(v["type"] for v in vops) == ("I" + "P" * 11) * 2 + "IP"
    assert {v["quant"] for v in vops} == {3} and {v.get("f_code") for v in vops} == {None, 1}
    assert [v.get("rounding_type") for v in vops[:14]] == [None] + [1, 0] * 5 + [1, None, 1]
    assert [(v["modulo_time_base"], v["time_increment"]) for v in vops] == [
        (int(i % 30 == 0 and i > 0), i % 30) for i in range(n)]


@pytest.mark.parametrize("fps, want", [(30.0, (30, 1)), (29.97, (2997, 100)), (0.45, (9, 20)),
                                       (23.976, (2997, 125)), (12.5, (25, 2))])
def test_time_base_is_cv2s(tmp_path, fps, want):
    """The reduced time base, the VOP times and ``CAP_PROP_FPS`` of cv2's
    file and of the port's, three 32x48 frames each."""
    assert video.time_base(fps) == want
    frames = [f[:32, :48] for f in fixture.make_frames("odd")[:3]]
    writer = cv2.VideoWriter(str(tmp_path / "cv2.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (48, 32))
    for frame in frames:
        writer.write(frame)
    writer.release()
    with video.VideoWriter(str(tmp_path / "port.mp4"), fps, (48, 32)) as port:
        for frame in frames:
            port.write(frame)
    seen = {}
    for who in ("cv2", "port"):
        data = (tmp_path / f"{who}.mp4").read_bytes()
        table = torch_mp4.sample_table(data)
        esds = torch_mp4.box(table["tree"], "moov/trak/mdia/minf/stbl/stsd/mp4v/esds")
        vol = torch_mp4.parse_headers(torch_mp4.esds_info(esds)["dsi"])
        vops = [torch_mp4.parse_vop(s, vol) for s in table["samples"]]
        seen[who] = (vol["time_resolution"],
                     [(v["modulo_time_base"], v["time_increment"]) for v in vops],
                     read_back(tmp_path / f"{who}.mp4")[1])
    assert seen["port"] == seen["cv2"]
    assert seen["port"][0] == want[0] and seen["port"][2] == pytest.approx(fps)


@pytest.mark.parametrize("shape", [(64, 96), (37, 51)])
def test_colour_twin_equals_native(shape):
    bgr = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    for got, want in zip(video.native_bgr_to_yuv420(bgr), video.bgr_to_yuv420(bgr)):
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("q", [3, 6, 17, 31])
@pytest.mark.parametrize("intra, chroma", [(True, False), (True, True), (False, False),
                                           (False, True)])
def test_block_twins_equal_native(intra, chroma, q):
    """samples -> levels (FDCT + quantiser) and levels -> the IDCT's output
    (inverse quantiser + simple IDCT) on 512 seeded blocks of each kind:
    smooth and noisy pixels (intra) or residuals (inter), and levels at the
    edges of their range."""
    rng = np.random.default_rng(q + 10 * intra + 100 * chroma)
    lo, hi = (0, 256) if intra else (-255, 256)
    noisy = rng.integers(lo, hi, (256, 64))
    ramp = np.clip(rng.integers(lo, hi, (256, 1)) + rng.integers(-4, 5, (256, 64)).cumsum(1),
                   lo, hi - 1)
    samples = np.concatenate([noisy, ramp]).astype(np.int16)
    levels = video.native_forward_blocks(samples, intra, chroma, q)
    assert np.array_equal(levels, video.forward_blocks(samples, intra, chroma, q))
    extreme = rng.integers(-2047, 2048, (64, 64)).astype(np.int16)
    sparse = (extreme * (rng.random((64, 64)) < 0.1)).astype(np.int16)
    for lv in (levels, extreme, sparse):
        if intra:
            lv = lv.copy()
            lv[:, 0] = np.abs(lv[:, 0]) % 256
        assert np.array_equal(video.native_inverse_blocks(lv, intra, chroma, q),
                              video.inverse_blocks(lv, intra, chroma, q))


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="MPEG-4 allows"):
        video.VideoWriter(str(tmp_path / "a.mp4"), 12345.678, (64, 48))
    with pytest.raises(ValueError, match="above 0"):
        video.VideoWriter(str(tmp_path / "a.mp4"), 0.0, (64, 48))
    with pytest.raises(ValueError, match="outside"):
        video.VideoWriter(str(tmp_path / "a.mp4"), 30.0, (1, 48))
    with pytest.raises(ValueError, match="cannot open"):
        video.VideoWriter(str(tmp_path / "missing" / "a.mp4"), 30.0, (64, 48))
    writer = video.VideoWriter(str(tmp_path / "b.mp4"), 30.0, (65, 49))
    writer.write(np.zeros((49, 65, 3), np.uint8))  # the odd column and row are dropped
    with pytest.raises(ValueError, match="does not fit"):
        writer.write(np.zeros((48, 66, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        writer.write(np.zeros((48, 64), np.uint8))
    writer.release()
    with pytest.raises(ValueError, match="released"):
        writer.write(np.zeros((48, 64, 3), np.uint8))
    frames, fps, count = read_back(tmp_path / "b.mp4")
    assert (len(frames), frames[0].shape, fps, count) == (1, (48, 64, 3), 30.0, 1)
