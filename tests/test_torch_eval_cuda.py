"""Card tests of the offline evaluation (marked ``cuda``; they skip on a
host without a GPU). This file imports neither flax nor the JAX package, so
it runs on the card's machine:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_eval_cuda.py -m cuda

Kernel B1 at the eval's K = 1000 on candidates from a real decode: a seeded
depth-0.33 / width-0.25 model at 192x320 (1,260 anchors, so K = min(1000,
anchors) = 1000), obj/cls prediction biases 0, at the eval batches 8 and 64.
The keep mask is held bit for bit against both plain versions, and the
card's ``postprocess_fixed`` rows against the plain postprocess of the same
predictions on the CPU.

The dedup eval built through the ``Exp`` API alone, as a library caller
(the trainer's per-epoch eval) builds it: its bf16 first-batch guard holds
with no cuDNN setting made by the caller.
"""

import json

import numpy as np
import pytest
import torch

from streamyolo_torch.data import SyntheticArgoverse
from streamyolo_torch.exp import get_exp
from streamyolo_torch.ops.nms import postprocess_fixed, select_candidates
from streamyolo_torch.ops.nms_cuda import nms_keep, nms_padded, nms_padded_sequential

from .torch_port_helpers import require_cuda, tiny_model

INPUT = (192, 320)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 64])
def test_b1_bit_exact_at_eval_k(batch):
    require_cuda()
    model = tiny_model(torch.bfloat16)
    frames = np.random.RandomState(batch).randint(0, 256, (batch, *INPUT, 6), np.uint8)
    with torch.inference_mode():
        preds = model(torch.from_numpy(frames).cuda(), mode="off_pipe")
        _, boxes, valid = select_candidates(preds, 8, 0.01, 1000)
        assert boxes.shape == (batch, 1000, 4) and bool(valid.all())
        launches = nms_keep.launches
        keep = nms_keep(boxes, valid, 0.65)
        torch.cuda.synchronize()
        assert nms_keep.launches == launches + 1
        assert torch.equal(keep, nms_padded(boxes, valid, 0.65))
        assert torch.equal(keep.cpu(), nms_padded_sequential(boxes.cpu(), valid.cpu(), 0.65))
        assert bool(keep.any()) and bool((valid & ~keep).any())
        rows = postprocess_fixed(preds, 8, 0.01, 0.65)
        assert nms_keep.launches == launches + 2
        assert torch.equal(rows.cpu(), postprocess_fixed(preds.cpu(), 8, 0.01, 0.65))


@pytest.mark.cuda
def test_dedup_guard_holds_through_the_exp_api(tmp_path):
    """bf16 modules, seeded weights with the obj/cls biases 0, cuDNN's
    default choice (benchmark off). 2 sequences of 5 and 4 frames in
    batches of 4 (the tail padded): the guard passes at (1.0, 5e-3) and B1
    runs once per batch; with cuDNN off for every batch the dedup and
    dual-frame forwards give the same COCO rows."""
    require_cuda()
    size = (96, 160)
    synth = SyntheticArgoverse(seq_lens=(5, 4), size=(2 * size[0], 2 * size[1]), seed=0)
    ann_dir = tmp_path / "Argoverse-HD" / "annotations"
    ann_dir.mkdir(parents=True)
    (ann_dir / "val.json").write_text(json.dumps(synth.data))
    exp = get_exp(exp_name="s_s50_onex_dfp_tal_flip")
    exp.merge(["depth", "0.33", "width", "0.25", "test_size", str(size),
               "data_dir", str(tmp_path), "data_num_workers", "0"])
    exp.compute_dtype = "bfloat16"
    model = exp.get_model("cuda")
    model.load_state_dict(exp.init_model())
    with torch.no_grad():
        for m in list(model.head.obj_preds) + list(model.head.cls_preds):
            m.bias.zero_()

    def run(name):
        evaluator = exp.get_evaluator(4, load_frame=synth.frame)
        fwd = (exp.get_dedup_forward_fn(model, evaluator.dataset) if name == "dedup"
               else exp.get_forward_fn(model))
        launches = nms_keep.launches
        _, rows = evaluator.evaluate(fwd, return_outputs=True)
        assert nms_keep.launches - launches == len(evaluator.dataloader) == 3
        if name == "dedup":
            box_diff, score_diff = fwd.last_guard
            assert box_diff <= 1.0 and score_diff <= 5e-3
        return rows

    with torch.backends.cudnn.flags(enabled=True, benchmark=False):
        run("dedup")
    with torch.backends.cudnn.flags(enabled=False):
        rows = run("dedup")
        assert rows and rows == run("no_dedup")
