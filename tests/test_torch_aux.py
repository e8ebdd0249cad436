"""The port's auxiliary modules against the JAX package, on the CPU:
``vis`` (drawn images, composites and files bit for bit: the JAX package
draws and writes with cv2, the port with its own ``vis/draw.py`` and
``imwrite``; ``make_video``'s file, from the port's own MPEG-4 encoder, is
read back with cv2),
``tools/vis_results.py`` (the rendered frames of both tools
byte for byte), the wandb sink without the ``wandb`` package,
``__version__`` and the box helpers the mosaic's mixup uses
(``ops/boxes.py``)."""

import os
import pickle
import sys

import numpy as np
import pytest

from streamyolo_tpu import __version__ as jax_version
from streamyolo_tpu import vis as jvis
from streamyolo_torch import __version__
from streamyolo_torch import vis as tvis
from streamyolo_torch.tools import vis_results as tvis_results
from streamyolo_torch.utils.wandb_logger import WandbLogger

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_version_is_the_jax_packages():
    assert __version__ == jax_version


@pytest.mark.parametrize("out_scale", [1.0, 0.75])
def test_drawn_detections_equal_jax(tmp_path, out_scale):
    img = np.random.RandomState(0).randint(0, 256, (60, 80, 3), np.uint8)
    boxes = [[10, 10, 40, 40], [5.4, 30.6, 70.2, 58.9], [0, 0, 3, 3]]
    labels, names, scores = [2, 0, 9], ["a", "b", "car"], [0.9, 0.2, 0.5]
    for kw in ({}, {"scores": scores, "score_th": 0.3}, {"scores": scores, "tracks": [7, 8, 9]}):
        np.testing.assert_array_equal(
            tvis.draw_detections(img, boxes, labels, names, out_scale=out_scale, **kw),
            jvis.draw_detections(img, boxes, labels, names, out_scale=out_scale, **kw))
    for fn in ("vis_det", "vis_track"):
        extra = (boxes, [1, 2, 3]) if fn == "vis_track" else (boxes,)
        out = {}
        for name, mod in (("port", tvis), ("jax", jvis)):
            path = str(tmp_path / name / f"{fn}.png")
            out[name] = getattr(mod, fn)(img, *extra, labels, names, scores=scores,
                                         out_scale=out_scale, out_file=path)
            out[name + "_file"] = cv2.imread(path)
        np.testing.assert_array_equal(out["port"], out["jax"])
        np.testing.assert_array_equal(out["port_file"], out["jax_file"])


def test_composites_and_swing_equal_jax():
    a = np.random.RandomState(1).randint(0, 256, (40, 100, 3), np.uint8)
    b = np.full((40, 100, 3), 200, np.uint8)
    np.testing.assert_array_equal(tvis.vis_contrast(a, b[:30]), jvis.vis_contrast(a, b[:30]))
    for kw in ({"split_pos": 0.5}, {"split_pos": 10.0, "horizontal": True, "line_width": 3},
               {"split_pos": -5.0, "line_width": 1, "split_in_pixels": True},
               {"split_pos": 0.7, "split_in_pixels": True}, {"split_pos": 130.0}):
        np.testing.assert_array_equal(tvis.contrast_composite(a, b, **kw),
                                      jvis.contrast_composite(a, b, **kw))
    for t in np.linspace(0, 16, 33):
        assert tvis.split_anime_swing(t, 50.0, 100, 15) == jvis.split_anime_swing(t, 50.0, 100, 15)


def test_video_and_galleries(tmp_path):
    frames = []
    for i in range(3):
        path = str(tmp_path / "vis" / "seq0" / f"f{i}.jpg")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, np.full((48, 64, 3), 40 * i, np.uint8))
        frames.append(path)
    cap = cv2.VideoCapture(tvis.make_video(frames, str(tmp_path / "a.mp4"), fps=10,
                                           numbered=True))
    assert cap.get(cv2.CAP_PROP_FPS) == 10
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    assert shapes == [(48, 64, 3)] * 3
    for mod, name in ((tvis, "port"), (jvis, "jax")):
        mod.html_gallery(frames, str(tmp_path / f"{name}.html"), sample=2, seed=3)
        mod.html_all_sequences(str(tmp_path / "vis"), str(tmp_path / f"{name}_all.html"),
                               per_seq=2)
    for stem in ("", "_all"):
        with open(tmp_path / f"port{stem}.html") as f, open(tmp_path / f"jax{stem}.html") as g:
            assert f.read() == g.read()


def test_vis_results_cli_equals_jax(fake_argoverse, tmp_path, monkeypatch):
    """Both tools on the same detections, with ``--contrast`` and the swing
    animation: the same rendered frames, byte for byte."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import vis_results as jtool

    ccf = [dict(image_id=1, category_id=2, bbox=[10.0, 20.0, 10.0, 8.0], score=0.9),
           dict(image_id=2, category_id=0, bbox=[3.0, 4.0, 30.0, 20.0], score=0.4)]
    res, res_b = tmp_path / "a.pkl", tmp_path / "b.pkl"
    for path, rows in ((res, ccf), (res_b, ccf[1:])):
        with open(path, "wb") as f:
            pickle.dump(rows, f)
    common = ["--data-root", os.path.join(fake_argoverse, "Argoverse-1.1", "tracking"),
              "--annot-path", os.path.join(fake_argoverse, "Argoverse-HD", "annotations",
                                           "val.json"),
              "--results", str(res), "--contrast", str(res_b), "--split-animation", "swing",
              "--score-th", "0.3", "--html"]
    tvis_results.main([*common, "--out-dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["vis_results.py", *common, "--out-dir",
                                      str(tmp_path / "jax")])
    jtool.main()
    rendered = sorted(p.relative_to(tmp_path / "jax")
                      for p in (tmp_path / "jax").rglob("*.jpg"))
    assert rendered and rendered == sorted(p.relative_to(tmp_path / "port")
                                           for p in (tmp_path / "port").rglob("*.jpg"))
    for rel in rendered:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert (tmp_path / "port" / "index.html").is_file()


def test_wandb_sink_without_wandb(monkeypatch, caplog):
    """No ``wandb`` package: one warning, then every call is a no-op;
    ``wandb-<key>`` opts are the ``init`` arguments."""
    import argparse
    import logging

    monkeypatch.setitem(sys.modules, "wandb", None)
    args = argparse.Namespace(opts=["wandb-project", "p", "depth", "0.33"])
    with caplog.at_level(logging.WARNING, logger="streamyolo_torch"):
        sink = WandbLogger.initialize_wandb_logger(args, argparse.Namespace(depth=0.33))
    assert any("no-op" in r.message for r in caplog.records)
    assert sink._run is None
    sink.log_metrics({"lr": 0.1}, step=1)
    sink.save_checkpoint("nowhere", "latest", True)
    sink.finish()


def test_wandb_sink_with_a_wandb(monkeypatch, tmp_path):
    """With a ``wandb`` module: ``init`` gets the ``wandb-`` opts and the
    config, metrics go to ``log``, the checkpoint is the ``.pth`` artifact."""
    import argparse
    import types

    calls = []

    class Run:
        def log_artifact(self, artifact, aliases=None):
            calls.append(("artifact", artifact.files, aliases))

        def finish(self):
            calls.append(("finish",))

    class Artifact:
        def __init__(self, name, type, metadata=None):
            self.files = []

        def add_file(self, path):
            self.files.append(path)

    fake = types.SimpleNamespace(
        init=lambda **kw: calls.append(("init", kw)) or Run(),
        log=lambda metrics, step=None: calls.append(("log", metrics, step)),
        Artifact=Artifact)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    sink = WandbLogger.initialize_wandb_logger(
        argparse.Namespace(opts=["wandb-project", "p"]), argparse.Namespace(depth=0.5))
    sink.log_metrics({"lr": 0.1})
    sink.save_checkpoint(str(tmp_path), "best", True)
    sink.finish()
    assert calls == [("init", {"project": "p", "name": None, "config": {"depth": 0.5}}),
                     ("log", {"lr": 0.1}, None),
                     ("artifact", [os.path.join(str(tmp_path), "best_ckpt.pth")], ["best"]),
                     ("finish",)]


def test_box_ops_equal_jax():
    """``elementwise_iou`` (both box formats), ``xyxy2xywh`` and
    ``adjust_box_anns`` against the JAX package's, fp32 atol 1e-6."""
    import jax.numpy as jnp
    import torch

    from streamyolo_tpu.ops import boxes as jboxes
    from streamyolo_torch.ops import boxes as tboxes

    rng = np.random.RandomState(3)
    a = rng.uniform(0, 50, (2, 7, 4)).astype(np.float32)
    b = rng.uniform(0, 50, (2, 7, 4)).astype(np.float32)
    a[..., 2:] += a[..., :2]
    b[..., 2:] += b[..., :2]
    b[0, 0] = a[0, 0]  # identical boxes: IoU 1
    b[0, 1] = [100, 100, 110, 120]  # disjoint: 0
    for xyxy in (True, False):
        want = np.asarray(jboxes.elementwise_iou(jnp.asarray(a), jnp.asarray(b), xyxy=xyxy))
        got = tboxes.elementwise_iou(torch.from_numpy(a), torch.from_numpy(b), xyxy=xyxy)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tboxes.xyxy2xywh(a), jboxes.xyxy2xywh(a), atol=0, rtol=0)
    np.testing.assert_array_equal(tboxes.xyxy2xywh(torch.from_numpy(a)).numpy(),
                                  tboxes.xyxy2xywh(a))
    np.testing.assert_array_equal(tboxes.adjust_box_anns(a[0], 1.7, -4, 6, 60, 40),
                                  jboxes.adjust_box_anns(a[0], 1.7, -4, 6, 60, 40))
