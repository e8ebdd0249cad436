#!/usr/bin/env python3
"""Render detection results over the source frames, the port's counterpart
of ``tools/vis_results.py``: per-frame overlays of a CCF results pkl
(``results_ccf.pkl``), optionally one mp4 per sequence and an HTML gallery.

    python -m streamyolo_torch.tools.vis_results --data-root D/Argoverse-1.1/tracking \
        --annot-path D/Argoverse-HD/annotations/val.json --results results_ccf.pkl \
        --out-dir OUT [--score-th 0.3] [--video] [--html] [--contrast B.pkl]

``--contrast B.pkl`` renders a second experiment's detections on the same
frames and composes the two panes split-screen (A before the divider, B
after), with ``--split-pos``, ``--horizontal`` and the ``--split-animation
swing`` divider sweep. Frames are read, drawn on and written without cv2
(``data/image_io.py``, whose ``imwrite`` writes cv2's bytes for a JPEG or
PNG name, and ``vis/draw.py``, cv2 5.0's ``rectangle`` and ``putText`` bit
for bit), so the files equal the JAX tool's byte for byte. ``--video``
encodes each sequence with ``vis.make_video`` (the port's MPEG-4 encoder,
``vis/video.py``): the file cv2's ``mp4v`` writer makes, held to what cv2
reads back from the JAX tool's video rather than to its bytes.
"""

from __future__ import annotations

import argparse
import os
import pickle
from collections import defaultdict
from typing import Optional, Sequence


def _load_ccf(path):
    with open(path, "rb") as f:
        results_ccf = pickle.load(f)
    by_img = defaultdict(list)
    for det in results_ccf:
        by_img[det["image_id"]].append(det)
    return by_img


def _render(frame, dets, class_names, score_th, vis_scale, vis_det):
    bboxes = [[d["bbox"][0], d["bbox"][1],
               d["bbox"][0] + d["bbox"][2], d["bbox"][1] + d["bbox"][3]]
              for d in dets]
    labels = [d["category_id"] for d in dets]
    scores = [d["score"] for d in dets]
    return vis_det(frame, bboxes, labels, class_names, scores=scores,
                   score_th=score_th, out_scale=vis_scale)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser("streamyolo_torch vis_results")
    parser.add_argument("--data-root", type=str, required=True)
    parser.add_argument("--annot-path", type=str, required=True)
    parser.add_argument("--results", type=str, required=True,
                        help="results_ccf.pkl (CCF list) path")
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--score-th", type=float, default=0.3)
    parser.add_argument("--vis-scale", type=float, default=1.0)
    parser.add_argument("--video", action="store_true", default=False,
                        help="also encode one mp4 per sequence")
    parser.add_argument("--html", action="store_true", default=False,
                        help="also write an HTML gallery")
    parser.add_argument("--fps", type=float, default=30)
    parser.add_argument("--contrast", type=str, default=None, metavar="B_PKL",
                        help="second experiment's results_ccf.pkl: render "
                             "both and compose split-screen (A | B)")
    parser.add_argument("--split-pos", type=float, default=0.5,
                        help="divider position: fraction (<=1) or pixels")
    parser.add_argument("--horizontal", action="store_true", default=False,
                        help="split top/bottom instead of left/right")
    parser.add_argument("--split-animation", type=str, default=None,
                        choices=["swing"],
                        help="animate the divider over frame time (fps clock)")
    args = parser.parse_args(argv)

    from streamyolo_torch.data.coco import COCO
    from streamyolo_torch.data.image_io import imread, imwrite
    from streamyolo_torch.vis import (
        contrast_composite,
        html_all_sequences,
        make_video,
        split_anime_swing,
        vis_det,
    )

    db = COCO(args.annot_path)
    class_names = [c["name"] for c in db.dataset["categories"]]
    seq_dirs = db.dataset["seq_dirs"]

    by_img = _load_ccf(args.results)
    by_img_b = _load_ccf(args.contrast) if args.contrast else None

    seq_frames = defaultdict(list)
    for img in db.dataset["images"]:
        path = os.path.join(args.data_root, seq_dirs[img["sid"]], img["name"])
        frame = imread(path)
        canvas = _render(frame, by_img.get(img["id"], []), class_names,
                         args.score_th, args.vis_scale, vis_det)
        if by_img_b is not None:
            canvas_b = _render(frame, by_img_b.get(img["id"], []), class_names,
                               args.score_th, args.vis_scale, vis_det)
            split = args.split_pos
            animated = args.split_animation == "swing"
            if animated:
                h, w = canvas.shape[:2]
                length = h if args.horizontal else w
                base = split if split > 1 else length * split
                split = split_anime_swing(
                    img["fid"] / args.fps, base, length, 15)
            canvas = contrast_composite(canvas, canvas_b, split_pos=split,
                                        horizontal=args.horizontal,
                                        split_in_pixels=animated)
        seq_name = db.dataset["sequences"][img["sid"]]
        out_file = os.path.join(args.out_dir, seq_name, img["name"])
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        imwrite(out_file, canvas)
        seq_frames[seq_name].append(out_file)

    if args.video:
        for seq, frames in seq_frames.items():
            out = make_video(frames, os.path.join(args.out_dir, seq + ".mp4"),
                             fps=args.fps)
            print(f"wrote {out}")
    if args.html:
        out = html_all_sequences(args.out_dir, os.path.join(args.out_dir, "index.html"))
        print(f"wrote {out}")
    print(f"rendered {sum(len(v) for v in seq_frames.values())} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
