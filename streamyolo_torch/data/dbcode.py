"""Dataset builders for the streaming harness: the port's own copy of
``streamyolo_tpu/data/dbcode.py``.

  * ``db_from_img_folder``: a COCO-format dataset skeleton from a folder of
    frames;
  * ``pseudo_gt_from_detections``: pseudo ground truth from detector outputs,
    with optional class-id remapping;
  * ``SyntheticArgoverse`` / ``make_synthetic_argoverse``: the deterministic
    Argoverse-HD-format video dataset (moving rectangles on a textured
    background) that the sAP rehearsal runs on when the real data is absent.
    ``SyntheticArgoverse`` keeps it in memory and renders frames on demand;
    ``make_synthetic_argoverse`` writes it as JPEG frames plus annotation
    JSON, in the JAX package's layout.

Nothing here imports cv2: ``db_from_img_folder`` takes each frame's size
from its JPEG or PNG header and ``make_synthetic_argoverse`` writes its
frames with ``data/image_io.py``'s ``imwrite``, byte for byte what
``cv2.imwrite`` writes. The generator draws from its RNG in the JAX
package's order, so the annotations are the same; the background is
upscaled by ``data/cv2_ops.py::resize_u8``, equal to ``cv2.resize`` with
``INTER_LINEAR`` bit for bit, so the frames, and the files, are the JAX
package's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from streamyolo_torch.data.argoverse_classes import ARGOVERSE_CLASSES, COCO_SUBSET
from streamyolo_torch.data.cv2_ops import resize_u8
from streamyolo_torch.data.image_io import image_size, imwrite

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic_light", "fire_hydrant", "stop_sign",
    "parking_meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports_ball", "kite",
    "baseball_bat", "baseball_glove", "skateboard", "surfboard",
    "tennis_racket", "bottle", "wine_glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot_dog", "pizza", "donut", "cake", "chair", "couch", "potted_plant",
    "bed", "dining_table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell_phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy_bear",
    "hair_drier", "toothbrush",
)

# coco id -> argoverse-hd id for the 8-class subset
COCO_TO_AVHD: Dict[int, int] = {c: i for i, c in enumerate(COCO_SUBSET)}

# one bright BGR color per class id 0..7
PALETTE = (
    (60, 200, 255), (80, 255, 120), (255, 160, 60), (200, 80, 255),
    (255, 255, 80), (120, 120, 255), (255, 100, 180), (90, 255, 255),
)

def db_from_img_folder(
    img_dir: str,
    out_path: Optional[str] = None,
    class_names: Sequence[str] = ARGOVERSE_CLASSES,
    fps: float = 30.0,
    exts: Sequence[str] = (".jpg", ".jpeg", ".png"),
) -> dict:
    """A COCO-format dataset dict (no annotations) from a folder of sequence
    subdirectories (or a flat folder = one sequence). Each frame's size is
    read from its JPEG or PNG header (``image_size``: the size
    ``cv2.imread`` returns, Exif orientation included), without decoding
    it."""
    entries = sorted(os.listdir(img_dir))
    seq_names = [e for e in entries if os.path.isdir(os.path.join(img_dir, e))]
    if not seq_names:
        seq_names = [""]

    images: List[dict] = []
    seq_dirs: List[str] = []
    sequences: List[str] = []
    img_id = 0
    for sid, seq in enumerate(seq_names):
        seq_path = os.path.join(img_dir, seq) if seq else img_dir
        sequences.append(seq or os.path.basename(os.path.normpath(img_dir)))
        seq_dirs.append(seq)
        frames = sorted(
            f for f in os.listdir(seq_path) if f.lower().endswith(tuple(exts))
        )
        for fid, name in enumerate(frames):
            h, w = image_size(os.path.join(seq_path, name))
            images.append(
                dict(id=img_id, width=w, height=h, name=name, sid=sid, fid=fid)
            )
            img_id += 1

    db = dict(
        images=images,
        annotations=[],
        categories=[dict(id=i, name=n) for i, n in enumerate(class_names)],
        sequences=sequences,
        seq_dirs=seq_dirs,
        fps=fps,
    )
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(db, f)
    return db


def pseudo_gt_from_detections(
    db: dict,
    results_ccf: Sequence[dict],
    score_th: float = 0.5,
    class_mapping: Optional[Dict[int, int]] = None,
    out_path: Optional[str] = None,
) -> dict:
    """Thresholded detections as annotations (pseudo ground truth),
    optionally remapping class ids (e.g. COCO -> Argoverse-HD subset)."""
    out = dict(db)
    anns = []
    ann_id = 0
    for det in results_ccf:
        if det["score"] < score_th:
            continue
        cat = det["category_id"]
        if class_mapping is not None:
            if cat not in class_mapping:
                continue
            cat = class_mapping[cat]
        x, y, w, h = det["bbox"]
        anns.append(
            dict(id=ann_id, image_id=det["image_id"], category_id=int(cat),
                 bbox=[float(x), float(y), float(w), float(h)],
                 area=float(w * h), iscrowd=0)
        )
        ann_id += 1
    out["annotations"] = anns
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return out


class SyntheticArgoverse:
    """A deterministic Argoverse-HD-format video dataset, in memory.

    Each sequence shows ``n_objects`` bright rectangles of per-class color
    drifting over a fixed textured background at constant per-object
    velocities (1-4 px/frame, bouncing off the borders: the motion scale at
    which a detector one frame late pairs against boxes a few px away).
    ``data`` is the COCO-format dict (``images`` with ``sid``/``fid``,
    ``annotations`` = the rectangles, ``sequences``, ``seq_dirs``, ``fps``);
    ``frame(img)`` renders one image dict's BGR uint8 frame."""

    def __init__(
        self,
        seq_lens: Sequence[int] = (75, 75, 75, 75),
        size: Sequence[int] = (300, 480),
        n_objects: int = 4,
        fps: float = 30.0,
        seed: int = 0,
        obj_frac: Sequence[float] = (1 / 16, 1 / 6),
    ):
        h, w = int(size[0]), int(size[1])
        rng = np.random.RandomState(seed)
        seq_dirs = [f"seq{sid:02d}" for sid in range(len(seq_lens))]
        self.backgrounds: List[np.ndarray] = []
        images: List[dict] = []
        annotations: List[dict] = []
        img_id = ann_id = 0
        for sid, n_frames in enumerate(seq_lens):
            # fixed per-sequence textured background (coarse noise, upscaled)
            self.backgrounds.append(resize_u8(
                rng.randint(20, 90, (h // 10, w // 10, 3), np.uint8), h, w))
            objs = []
            lo, hi = obj_frac  # object extent as a fraction of the frame
            for _ in range(n_objects):
                bw = int(rng.randint(max(2, int(w * lo)), max(3, int(w * hi))))
                bh = int(rng.randint(max(2, int(h * lo * 1.3)),
                                     max(3, int(h * hi * 1.3))))
                objs.append(dict(
                    x=float(rng.randint(0, w - bw)), y=float(rng.randint(0, h - bh)),
                    vx=float(rng.uniform(1, 4) * rng.choice([-1, 1])),
                    vy=float(rng.uniform(0.5, 2) * rng.choice([-1, 1])),
                    bw=bw, bh=bh, cat=int(rng.randint(0, 8)),
                ))
            for fid in range(n_frames):
                for o in objs:
                    # bounce off the borders so objects stay in frame
                    if not (0 <= o["x"] + o["vx"] <= w - o["bw"]):
                        o["vx"] = -o["vx"]
                    if not (0 <= o["y"] + o["vy"] <= h - o["bh"]):
                        o["vy"] = -o["vy"]
                    if fid:
                        o["x"] += o["vx"]
                        o["y"] += o["vy"]
                    x, y = int(round(o["x"])), int(round(o["y"]))
                    annotations.append(dict(
                        id=ann_id, image_id=img_id, category_id=o["cat"],
                        bbox=[float(x), float(y), float(o["bw"]), float(o["bh"])],
                        area=float(o["bw"] * o["bh"]), iscrowd=0,
                    ))
                    ann_id += 1
                images.append(dict(
                    id=img_id, width=w, height=h, sid=sid, fid=fid,
                    name=f"{fid:06d}.jpg"))
                img_id += 1
        categories = [dict(id=i, name=n) for i, n in enumerate(ARGOVERSE_CLASSES)]
        self.data = dict(images=images, annotations=annotations,
                         categories=categories, seq_dirs=seq_dirs,
                         sequences=seq_dirs, fps=fps)
        self._anns: Dict[int, List[dict]] = {}
        for ann in annotations:
            self._anns.setdefault(ann["image_id"], []).append(ann)

    def frame(self, img: dict) -> np.ndarray:
        """The BGR uint8 frame of image dict ``img``: the sequence's
        background with the rectangles painted in annotation order."""
        frame = self.backgrounds[img["sid"]].copy()
        for ann in self._anns.get(img["id"], []):
            x, y, bw, bh = (int(v) for v in ann["bbox"])
            frame[y:y + bh, x:x + bw] = PALETTE[ann["category_id"]]
        return frame


def make_synthetic_argoverse(
    root: str,
    seq_lens: Sequence[int] = (75, 75, 75, 75),
    size: Sequence[int] = (300, 480),
    n_objects: int = 4,
    fps: float = 30.0,
    seed: int = 0,
    splits: Sequence[str] = ("val.json",),
    obj_frac: Sequence[float] = (1 / 16, 1 / 6),
) -> str:
    """Write ``SyntheticArgoverse`` under ``root`` in the Argoverse-HD layout:
    ``Argoverse-1.1/tracking/<seq>/<frame>.jpg`` (JPEG quality 90) plus
    ``Argoverse-HD/annotations/<split>`` COCO jsons, each file byte for byte
    the JAX package's. Returns ``str(root)``."""
    synth = SyntheticArgoverse(seq_lens, size, n_objects, fps, seed, obj_frac)
    ann_dir = os.path.join(root, "Argoverse-HD", "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    seq_dirs = synth.data["seq_dirs"]
    for img in synth.data["images"]:
        d = os.path.join(root, "Argoverse-1.1", "tracking", seq_dirs[img["sid"]])
        os.makedirs(d, exist_ok=True)
        imwrite(os.path.join(d, img["name"]), synth.frame(img), quality=90)
    for split in splits:
        with open(os.path.join(ann_dir, split), "w") as f:
            json.dump(synth.data, f)
    return str(root)
