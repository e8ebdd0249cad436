"""Card tests of the training slice (marked ``cuda``; they skip on a host
without a GPU). This file imports neither flax nor the JAX package, so it
runs on the card's machine:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_train_cuda.py -m cuda

  * a bf16 autocast train step of the depth-0.33 / width-0.25 model on the
    card: finite losses, float32 master weights (dtype unchanged, values
    moved), float32 momentum and EMA;
  * SimOTA on the card equal to the CPU on identical inputs (``fg_mask``,
    ``matched_gt``, ``num_fg``; ``pred_iou`` atol 1e-6), crowded gts and
    exact cost ties included;
  * ``DevicePrefetcher``'s pinned side-stream copy delivers the bytes it was
    given, on the card, ready for the caller's stream.
"""

import numpy as np
import pytest
import torch

from streamyolo_torch.data.loader import DevicePrefetcher
from streamyolo_torch.models.assign import simota_assign_batch
from streamyolo_torch.models.heads import level_grids
from streamyolo_torch.train import build_lr_schedule, create_train_state, make_train_step

from .torch_port_helpers import require_cuda, tiny_model

NCLS = 8


def batch_of(seed, b=4, hw=(128, 192), device="cuda"):
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, 10, 5), np.float32)
    for i in range(b):
        k = 3 + i
        labels[i, :k, 0] = rng.randint(0, NCLS, k)
        labels[i, :k, 1] = rng.uniform(20, hw[1] - 20, k)
        labels[i, :k, 2] = rng.uniform(20, hw[0] - 20, k)
        labels[i, :k, 3:5] = rng.uniform(10, 60, (k, 2))
    support = labels.copy()
    support[..., 1:3] += rng.normal(0, 2, support[..., 1:3].shape).astype(np.float32)
    support[labels.sum(-1) == 0] = 0.0
    images = rng.randint(0, 256, (b, *hw, 6)).astype(np.uint8)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("images", images), ("labels", labels), ("support_labels", support))}


@pytest.mark.cuda
def test_bf16_autocast_step_on_the_card():
    require_cuda()
    model = tiny_model(torch.float32).train()
    state = create_train_state(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(NCLS, build_lr_schedule("constant", 0.01, 10, 10), fp16=True)
    for i in range(3):
        metrics = step(state, batch_of(i))
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert state.step == 3
    assert all(p.dtype == torch.float32 and p.is_cuda for p in model.parameters())
    assert all(v.dtype == before[k].dtype for k, v in state.ema.state.items())
    assert all(s["momentum_buffer"].dtype == torch.float32
               for s in state.optimizer.state.values())
    assert not torch.equal(before["head.reg_preds.0.weight"], model.head.reg_preds[0].weight)
    assert not torch.equal(before["backbone.jian2.bn.running_var"],
                           model.backbone.jian2.bn.running_var)


def assign_inputs(seed, n_valid, hw=((16, 24), (8, 12), (4, 6)), crowd=False, ties=False):
    rng = np.random.RandomState(seed)
    xy, s, _ = level_grids(hw, (8, 16, 32))
    n, b = xy.shape[0], len(n_valid)
    labels = np.zeros((b, 12, 5), np.float32)
    for i, k in enumerate(n_valid):
        labels[i, :k, 0] = rng.randint(0, NCLS, k)
        labels[i, :k, 1:3] = (np.array([60.0, 50.0]) + rng.normal(0, 4, (k, 2)) if crowd
                              else rng.uniform(10, 120, (k, 2)))
        labels[i, :k, 3:5] = rng.uniform(10, 50, (k, 2))
    centers = (xy + 0.5) * s[:, None]
    preds = np.concatenate([centers + rng.normal(0, 4, (b, n, 2)),
                            rng.uniform(6, 50, (b, n, 2))], -1).astype(np.float32)
    obj = rng.normal(0, 2, (b, n)).astype(np.float32)
    cls = rng.normal(0, 2, (b, n, NCLS)).astype(np.float32)
    if ties:  # groups of 4 anchors with identical predictions
        idx = (np.arange(n) // 4) * 4
        preds, obj, cls = preds[:, idx], obj[:, idx], cls[:, idx]
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in (labels, preds, obj, cls, xy, s)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "crowded", "ties"])
def test_simota_on_the_card_equals_the_cpu(case):
    require_cuda()
    kw = {"plain": dict(seed=0, n_valid=(3, 0, 7)),
          "crowded": dict(seed=1, n_valid=(12, 9), crowd=True),
          "ties": dict(seed=2, n_valid=(6, 8), crowd=True, ties=True)}[case]
    inputs = assign_inputs(**kw)
    want = simota_assign_batch(*inputs, NCLS)
    got = simota_assign_batch(*(t.cuda() for t in inputs), NCLS)
    assert torch.equal(got.fg_mask.cpu(), want.fg_mask)
    assert torch.equal(got.matched_gt.cpu(), want.matched_gt)
    assert torch.equal(got.num_fg.cpu(), want.num_fg)
    assert torch.allclose(got.pred_iou.cpu(), want.pred_iou, atol=1e-6, rtol=0)
    assert int(want.num_fg.sum()) > 0


@pytest.mark.cuda
def test_prefetcher_side_stream_delivers_the_bytes():
    require_cuda()
    rng = np.random.RandomState(0)
    raw = [(rng.randint(0, 256, (8, 600, 960, 6), np.uint8),
            (rng.normal(size=(8, 120, 5)).astype(np.float32),
             rng.normal(size=(8, 120, 5)).astype(np.float32))) for _ in range(3)]
    pf = DevicePrefetcher(raw)
    for images, (labels, support) in raw:
        batch = pf.next()
        # the caller's stream would run here; it reads the batch at once
        assert batch["images"].is_cuda and batch["images"].dtype == torch.uint8
        assert torch.equal(batch["images"].cpu(), torch.from_numpy(images))
        assert torch.equal(batch["labels"].cpu(), torch.from_numpy(labels))
        assert torch.equal(batch["support_labels"].cpu(), torch.from_numpy(support))
        total = batch["images"].sum(dtype=torch.int64)  # a kernel on the caller's stream
        assert int(total) == int(images.sum(dtype=np.int64))
    assert pf.next() is None
    pf.close()
