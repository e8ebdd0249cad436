"""Card tests of the N-camera path and the native COCOeval (marked ``cuda``;
they skip on a host without a GPU). This file imports neither flax nor the
JAX package, so it runs on the card's machine:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_multistream_cuda.py -m cuda

Kernel B1 inside a batched multi-stream step: one launch per step, and the
card's [N, K, 8] block equal bit for bit to the plain postprocess of the same
predictions moved to the CPU. The native ``COCOeval_opt`` against the NumPy
``COCOeval`` on randomised cases, ``stats`` and ``precision`` within 1e-12.
"""

import numpy as np
import pytest
import torch

from streamyolo_torch.data.coco import COCO
from streamyolo_torch.eval import COCOeval, COCOeval_opt
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead, init_weights
from streamyolo_torch.ops.nms import postprocess_fixed
from streamyolo_torch.ops.nms_cuda import nms_keep
from streamyolo_torch.stream import MultiStreamDetector

from .torch_port_helpers import require_cuda

INPUT = (64, 96)


def tiny_model(dtype):
    """Depth 0.33, width 0.25, seeded weights, obj/cls prediction biases 0
    (so NMS sees candidates), on the card."""
    model = init_weights(StreamYOLO(DFPPAFPN(0.33, 0.25), TALHead(num_classes=8, width=0.25)),
                         torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in list(model.head.obj_preds) + list(model.head.cls_preds):
            m.bias.zero_()
    return model.to(device="cuda", dtype=dtype).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_stream_launches_b1_once_per_step(dtype):
    require_cuda()
    model = tiny_model(dtype)
    det = MultiStreamDetector(model, 4, input_size=INPUT, conf_thre=0.01, nms_thre=0.65,
                              pre_nms_topk=100, use_bf16=dtype == torch.bfloat16)
    seen = []
    hook = model.register_forward_hook(lambda mod, inp, out: seen.append(out[0]))
    rng = np.random.RandomState(0)
    nms_keep.launches = 0
    steps = 6
    for t in range(steps):
        if t == 3:
            det.reset(2)
        frames = rng.randint(0, 256, (4, *INPUT, 3), np.uint8)
        det(frames, preprocessed=True)
        assert nms_keep.launches == t + 1
        plain = postprocess_fixed(seen[-1].cpu(), 8, 0.01, 0.65, 100)
        assert torch.equal(torch.from_numpy(det.last_rows), plain)
        assert (det.last_rows[..., 7] > 0.5).sum() > 0
    hook.remove()
    assert nms_keep.launches == steps


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_cocoeval_matches_numpy(seed):
    require_cuda()
    rng = np.random.default_rng(seed)
    images = [dict(id=i, width=640, height=480) for i in range(6)]
    anns = []
    for i in range(6):
        for _ in range(rng.integers(1, 8)):
            w, h = rng.uniform(8, 120, 2)
            anns.append(dict(id=len(anns) + 1, image_id=i, category_id=int(rng.integers(1, 4)),
                             bbox=[float(rng.uniform(0, 640 - w)), float(rng.uniform(0, 480 - h)),
                                   float(w), float(h)], area=float(w * h),
                             iscrowd=int(rng.random() < 0.15)))
    gt = COCO(dict(images=images, annotations=anns,
                   categories=[dict(id=c, name=f"c{c}") for c in (1, 2, 3)]))
    res = [dict(image_id=a["image_id"], category_id=a["category_id"], score=float(rng.random()),
                bbox=[v + float(rng.normal(0, 8)) for v in a["bbox"][:2]] + a["bbox"][2:])
           for a in anns if rng.random() < 0.8]
    dt = gt.loadRes(res)
    evals = []
    for cls in (COCOeval, COCOeval_opt):
        e = cls(gt, dt, "bbox")
        e.evaluate()
        e.accumulate()
        e.summarize()
        evals.append(e)
    np.testing.assert_allclose(evals[1].stats, evals[0].stats, atol=1e-12, rtol=0)
    np.testing.assert_allclose(evals[1].eval["precision"], evals[0].eval["precision"], atol=1e-12)
