"""Visualisation, the port's own copy of ``streamyolo_tpu/vis``: detection
overlays (``draw_detections``, ``vis_det``, ``vis_track``), side-by-side and
split-screen comparisons (``vis_contrast``, ``contrast_composite`` with the
``split_anime_swing`` divider), frames to video (``make_video``) and HTML
galleries.

Frames are read with ``data/image_io.py::imread``, rescaled with
``data/cv2_ops.py::resize_u8``, drawn on with ``vis/draw.py`` and written
with ``data/image_io.py::imwrite`` (``cv2.imread``, ``cv2.resize``,
``cv2.rectangle``, ``cv2.putText`` and ``cv2.imwrite`` bit for bit for JPEG
and PNG, no cv2; any other extension raises ``ValueError``). cv2 5.0's
``putText`` renders ``FONT_HERSHEY_SIMPLEX`` with the TrueType font it
embeds, which ``vis/draw.py`` renders the same way (``native/draw.cpp``).
Only ``make_video`` still needs cv2, for its MPEG-4 encoder
(``cv2.VideoWriter``), imported inside it, so the module imports and draws
on a host without cv2 (the card's machine).
"""

from __future__ import annotations

import html
import os
import random
from typing import List, Optional, Sequence

import numpy as np

from streamyolo_torch.data.cv2_ops import resize_u8
from streamyolo_torch.data.image_io import imread, imwrite
from streamyolo_torch.vis.draw import put_text, rectangle

# deterministic per-class palette
_PALETTE = [
    (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
    (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
]


def draw_detections(
    img: np.ndarray,
    bboxes_ltrb: Sequence[Sequence[float]],
    labels: Sequence[int],
    class_names: Sequence[str],
    scores: Optional[Sequence[float]] = None,
    score_th: float = 0.0,
    tracks: Optional[Sequence[int]] = None,
    out_scale: float = 1.0,
) -> np.ndarray:
    """Draw boxes/labels(/scores/track-ids) on a copy of ``img`` (BGR)."""
    canvas = img.copy()
    for i, box in enumerate(bboxes_ltrb):
        if scores is not None and scores[i] < score_th:
            continue
        x1, y1, x2, y2 = (int(round(v)) for v in box[:4])
        cls = int(labels[i])
        color = _PALETTE[cls % len(_PALETTE)]
        rectangle(canvas, (x1, y1), (x2, y2), color, 2)
        text = class_names[cls] if cls < len(class_names) else str(cls)
        if scores is not None:
            text += f" {scores[i]:.2f}"
        if tracks is not None:
            text += f" #{int(tracks[i])}"
        put_text(canvas, text, (x1, max(y1 - 4, 10)), 0.5, color, 1)
    if out_scale != 1.0:
        # cv2's size for fx = fy = out_scale; the map's scale is the sizes'
        # ratio (cv2's fx path takes out_scale itself: equal where the scaled
        # sizes are whole numbers)
        h, w = canvas.shape[:2]
        canvas = resize_u8(canvas, round(h * out_scale), round(w * out_scale))
    return canvas


# the StreamYOLO sAP tools' name for the drawer
def vis_det(img, bboxes, labels, class_names, masks=None, scores=None,
            score_th=0.0, out_scale=1.0, out_file=None):
    canvas = draw_detections(
        img, bboxes, labels, class_names, scores=scores,
        score_th=score_th, out_scale=out_scale,
    )
    if out_file:
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        imwrite(out_file, canvas)
    return canvas


def vis_track(img, bboxes, tracks, labels, class_names, masks=None,
              scores=None, out_scale=1.0, out_file=None):
    canvas = draw_detections(
        img, bboxes, labels, class_names, scores=scores, tracks=tracks,
        out_scale=out_scale,
    )
    if out_file:
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        imwrite(out_file, canvas)
    return canvas


def vis_contrast(img_a: np.ndarray, img_b: np.ndarray, axis: int = 1) -> np.ndarray:
    """Side-by-side (or stacked) comparison canvas; the split-screen one is
    :func:`contrast_composite`."""
    h = min(img_a.shape[0], img_b.shape[0])
    w = min(img_a.shape[1], img_b.shape[1])
    return np.concatenate([img_a[:h, :w], img_b[:h, :w]], axis=axis)


# the divider colour, RGB (241, 159, 93), as BGR
_CONTRAST_LINE_BGR = (93, 159, 241)


def ease_in_out(t: float) -> float:
    """Cosine easing, time 0-1 -> progress 0-1."""
    return float(-np.cos(np.pi * t) / 2 + 0.5)


def split_anime_swing(t: float, split_pos: float, length: int,
                      line_width: int) -> float:
    """The 14-second swing animation of the split divider: hold at ``split_pos`` (4 s), sweep to the far
    edge (1 s), hold (3 s), sweep all the way to the near edge (2 s), hold
    (3 s), sweep back to ``split_pos`` (1 s); then hold."""
    durations = [4, 1, 3, 2, 3, 1]
    small_end = -line_width // 2 - 1
    big_end = length + line_width // 2
    keyframes = [split_pos, big_end, big_end, small_end, small_end, split_pos]
    last_key = 0.0
    start = split_pos
    for dur, end in zip(durations, keyframes):
        if t < last_key + dur:
            if start == end:
                return start
            p = ease_in_out((t - last_key) / dur)
            return start + p * (end - start)
        last_key += dur
        start = end
    return split_pos


def contrast_composite(
    img_a: np.ndarray,
    img_b: np.ndarray,
    split_pos: float = 0.5,
    horizontal: bool = False,
    line_width: int = 15,
    line_color=_CONTRAST_LINE_BGR,
    split_in_pixels: bool = False,
) -> np.ndarray:
    """Split-screen composite of two same-size frames: ``img_a`` before the
    divider, ``img_b`` after, with a coloured divider band (the sAP tools'
    contrast rendering). ``split_pos`` <= 1 is a fraction of the split axis,
    > 1 is pixels (it may leave the frame during an animation);
    ``split_in_pixels`` forces the pixel reading (animated positions can
    legitimately land in [0, 1]); ``horizontal`` splits top/bottom instead
    of left/right."""
    assert img_a.shape == img_b.shape, (img_a.shape, img_b.shape)
    h, w = img_a.shape[:2]
    length = h if horizontal else w
    if split_in_pixels:
        pos = split_pos
    else:
        pos = split_pos if split_pos > 1 else length * split_pos
    pos = int(round(pos))
    line_start = pos - (line_width - 1) // 2
    line_end = pos + line_width // 2  # exclusive after clamping, as upstream

    if pos <= 0:
        img = img_b.copy()
    else:
        img = img_a.copy()
        if horizontal:
            img[pos:] = img_b[pos:]
        else:
            img[:, pos:] = img_b[:, pos:]

    if line_start < length and line_end >= 0:
        line_start = max(0, line_start)
        line_end = min(length, line_end)
        color = np.asarray(line_color, img.dtype).reshape((1, 1, 3))
        if horizontal:
            img[line_start:line_end, :] = color
        else:
            img[:, line_start:line_end] = color
    return img


def make_video(
    frame_paths: Sequence[str], out_path: str, fps: float = 30.0,
    numbered: bool = False,
) -> str:
    """Encode an ordered list of frames into an mp4 (`make_videos.py` /
    `make_videos_numbered.py` roles; ``numbered`` stamps the frame index,
    drawn without cv2). The encoder is still ``cv2.VideoWriter``'s MPEG-4
    (``mp4v``), so this function alone needs cv2."""
    import cv2

    assert frame_paths, "no frames"
    h, w = imread(frame_paths[0]).shape[:2]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for i, p in enumerate(frame_paths):
        frame = resize_u8(imread(p), h, w)
        if numbered:
            put_text(frame, str(i), (10, 30), 1.0, (0, 255, 255), 2)
        writer.write(frame)
    writer.release()
    return out_path


def html_gallery(
    image_paths: Sequence[str], out_path: str, title: str = "gallery",
    columns: int = 4, sample: Optional[int] = None, seed: int = 0,
) -> str:
    """Static HTML image gallery (`html_all_seq.py` / `html_sampled_img.py`
    roles; ``sample`` picks a random subset)."""
    paths = list(image_paths)
    if sample is not None and sample < len(paths):
        rng = random.Random(seed)
        paths = rng.sample(paths, sample)
    rows = []
    for i in range(0, len(paths), columns):
        cells = "".join(
            f'<td><a href="{html.escape(p)}"><img src="{html.escape(p)}" '
            f'style="max-width:320px"></a><br>{html.escape(os.path.basename(p))}</td>'
            for p in paths[i : i + columns]
        )
        rows.append(f"<tr>{cells}</tr>")
    doc = (
        f"<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title></head><body>"
        f"<h1>{html.escape(title)}</h1><table>{''.join(rows)}</table></body></html>"
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def html_all_sequences(
    vis_root: str, out_path: str, per_seq: int = 8, seed: int = 0
) -> str:
    """One gallery covering every sequence directory under ``vis_root``."""
    paths: List[str] = []
    for seq in sorted(os.listdir(vis_root)):
        seq_dir = os.path.join(vis_root, seq)
        if not os.path.isdir(seq_dir):
            continue
        frames = sorted(
            os.path.join(seq_dir, f)
            for f in os.listdir(seq_dir)
            if f.lower().endswith((".jpg", ".png", ".jpeg"))
        )
        step = max(len(frames) // per_seq, 1)
        paths.extend(frames[::step][:per_seq])
    return html_gallery(paths, out_path, title=os.path.basename(vis_root))
