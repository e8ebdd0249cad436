"""The port's training loss against the JAX package, on the CPU: box
geometry, SimOTA, every loss term (TAL and plain, with and without L1), and
the gradient of ``total_loss`` with respect to the head maps.

Inputs are made from a seed with NumPy and fed to both packages in float32
(the JAX side at ``jax_default_matmul_precision=highest``, tests/conftest.py).
Tolerances:

  * ``pairwise_iou``, the format converters: atol 1e-6;
  * SimOTA: ``fg_mask``, ``matched_gt`` and ``num_fg`` equal, ``pred_iou``
    atol 1e-6;
  * loss terms: rtol 1e-5;
  * gradients, per head map: max |d| <= 1e-5 * max |g| + 1e-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.models import assign as jassign
from streamyolo_tpu.models import losses as jlosses
from streamyolo_tpu.models.heads import level_grids as j_level_grids
from streamyolo_tpu.ops import boxes as jboxes
from streamyolo_torch.models import assign as tassign
from streamyolo_torch.models import losses as tlosses
from streamyolo_torch.ops import boxes as tboxes

from .torch_port_helpers import pin_threads

NCLS = 8
HW = ((8, 12), (4, 6), (2, 3))  # a 64x96 input at strides 8, 16, 32
STRIDES = (8, 16, 32)


one_thread = pin_threads(1)


def random_boxes(rng, n, img=(64, 96), lo=4, hi=40):
    cxy = rng.uniform(0, 1, (n, 2)) * np.array([img[1], img[0]])
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([cxy, wh], -1).astype(np.float32)


def make_labels(rng, b, m, n_valid, crowd=False):
    """[b, m, 5] (cls, cx, cy, w, h), the first ``n_valid[i]`` rows real."""
    labels = np.zeros((b, m, 5), np.float32)
    for i, k in enumerate(n_valid):
        boxes = random_boxes(rng, k)
        if crowd:  # all gts packed around one point: anchors contested
            boxes[:, :2] = np.array([40.0, 30.0]) + rng.normal(0, 3, (k, 2))
            boxes[:, 2:] = rng.uniform(14, 30, (k, 2))
        labels[i, :k, 0] = rng.randint(0, NCLS, k)
        labels[i, :k, 1:] = boxes
    return labels


def anchors(hw=HW):
    xy, s, _ = j_level_grids(hw, STRIDES)
    return xy, s


def assign_inputs(seed, n_valid, crowd=False, ties=False, hw=HW, m=8):
    rng = np.random.RandomState(seed)
    xy, s = anchors(hw)
    n, b = xy.shape[0], len(n_valid)
    labels = make_labels(rng, b, m, n_valid, crowd)
    centers = (xy + 0.5) * s[:, None]
    preds = np.concatenate([centers + rng.normal(0, 4, (b, n, 2)),
                            rng.uniform(6, 40, (b, n, 2))], -1).astype(np.float32)
    obj = rng.normal(0, 2, (b, n)).astype(np.float32)
    cls = rng.normal(0, 2, (b, n, NCLS)).astype(np.float32)
    if ties:  # groups of 4 anchors with identical predictions: equal costs
        for a in range(0, n - 3, 4):
            preds[:, a + 1:a + 4] = preds[:, a:a + 1]
            obj[:, a + 1:a + 4] = obj[:, a:a + 1]
            cls[:, a + 1:a + 4] = cls[:, a:a + 1]
        centers_b = np.broadcast_to(centers, preds[..., :2].shape)
        preds[..., :2] = centers_b[:, (np.arange(n) // 4) * 4]
    return labels, preds, obj, cls, xy, s


def test_pairwise_iou_matches_jax():
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 7), random_boxes(rng, 9)
    a[0, 2:] = 0.0  # an empty box
    b[1] = a[1]  # identical boxes
    for xyxy in (False, True):
        if xyxy:
            a, b = jboxes.cxcywh2xyxy(a), jboxes.cxcywh2xyxy(b)
        want = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b), xyxy=xyxy))
        got = tboxes.pairwise_iou(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b)),
                                  xyxy=xyxy).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # batched: one [B, Na, Nb] call equals the per-image calls
    aa, bb = torch.from_numpy(np.stack([a, a[::-1].copy()])), torch.from_numpy(np.stack([b, b]))
    batched = tboxes.pairwise_iou(aa, bb)
    for i in range(2):
        assert torch.equal(batched[i], tboxes.pairwise_iou(aa[i], bb[i]))


def test_box_format_converters_match_jax():
    boxes = random_boxes(np.random.RandomState(1), 11)
    for name in ("xyxy2cxcywh", "cxcywh2xyxy"):
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(boxes)))
        np.testing.assert_allclose(getattr(tboxes, name)(torch.from_numpy(boxes)).numpy(), want,
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(getattr(tboxes, name)(boxes), want, atol=1e-6, rtol=0)


def test_bce_probs_matches_jax():
    p = np.array([0.0, 1e-50, 0.3, 0.999, 1.0], np.float32)
    for y in (0.0, 1.0, 0.25):
        want = np.asarray(jassign._bce_probs(jnp.asarray(p), y))
        got = tassign._bce_probs(torch.from_numpy(p), y).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert np.isfinite(got).all() and got.max() <= 100.0


@pytest.mark.parametrize("case", ["plain", "crowded", "no_gt_image", "few_anchors", "ties"])
def test_simota_equal_to_jax(case):
    kw = {"plain": dict(seed=0, n_valid=(3, 5)),
          "crowded": dict(seed=1, n_valid=(8, 6), crowd=True),
          "no_gt_image": dict(seed=2, n_valid=(0, 4, 0)),
          "few_anchors": dict(seed=3, n_valid=(2, 3), hw=((2, 2), (1, 1), (1, 1)), m=4),
          "ties": dict(seed=4, n_valid=(5, 7), crowd=True, ties=True)}[case]
    labels, preds, obj, cls, xy, s = assign_inputs(**kw)
    want = jassign.simota_assign_batch(*(jnp.asarray(v) for v in (labels, preds, obj, cls, xy, s)),
                                       NCLS)
    got = tassign.simota_assign_batch(*(torch.from_numpy(v) for v in (labels, preds, obj, cls)),
                                      torch.from_numpy(xy), torch.from_numpy(s), NCLS)
    assert np.array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    assert np.array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
    assert np.array_equal(got.num_fg.numpy(), np.asarray(want.num_fg))
    assert np.array_equal(got.num_gt.numpy(), np.asarray(want.num_gt))
    np.testing.assert_allclose(got.pred_iou.numpy(), np.asarray(want.pred_iou), atol=1e-6, rtol=0)
    n_fg = got.fg_mask.sum(1).numpy()
    if case == "no_gt_image":
        assert n_fg[0] == n_fg[2] == 0 and n_fg[1] > 0
    else:
        assert (n_fg > 0).all()
    if case in ("crowded", "ties"):  # the conflict rule ran: some anchor had > 1 gt
        assert got.matched_gt[got.fg_mask].unique().numel() > 1


def head_maps(seed, b=2):
    """Per-level raw maps, NHWC for JAX and NCHW for the port."""
    rng = np.random.RandomState(seed)
    maps = []
    for h, w in HW:
        m = rng.normal(0, 1, (b, h, w, 5 + NCLS)).astype(np.float32)
        m[..., 2:4] = rng.uniform(0.5, 1.8, (b, h, w, 2))  # box sides ~ a few strides
        maps.append(m)
    return maps


def loss_inputs(seed, empty_support=False):
    rng = np.random.RandomState(100 + seed)
    labels = make_labels(rng, 2, 8, (4, 6))
    support = labels.copy()
    support[..., 1:3] += rng.normal(0, 2, support[..., 1:3].shape).astype(np.float32)
    support[labels.sum(-1) == 0] = 0.0
    if empty_support:
        support[1] = 0.0
    return head_maps(seed), labels, support


def j_losses(maps, labels, support, **kw):
    return jlosses.streamyolo_losses([jnp.asarray(m) for m in maps], jnp.asarray(labels),
                                     jnp.asarray(support) if support is not None else None,
                                     NCLS, **kw)


def t_maps(maps, requires_grad=False):
    return [torch.from_numpy(m.transpose(0, 3, 1, 2).copy()).requires_grad_(requires_grad)
            for m in maps]


LOSS_CASES = {
    "tal_l1": dict(use_tal=True, use_l1=True),
    "tal_no_l1": dict(use_tal=True, use_l1=False),
    "plain_l1": dict(use_tal=False, use_l1=True),
    "plain_no_l1": dict(use_tal=False, use_l1=False),
    "tal_empty_support": dict(use_tal=True, use_l1=True, empty_support=True),
    "tal_gamma_thr": dict(use_tal=True, use_l1=True, gamma=1.5, ignore_thr=0.4,
                          ignore_value=1.7),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_terms_match_jax(case):
    kw = dict(LOSS_CASES[case])
    maps, labels, support = loss_inputs(1, kw.pop("empty_support", False))
    sup = support if kw["use_tal"] else None
    want = j_losses(maps, labels, sup, **kw)
    got = tlosses.streamyolo_losses(t_maps(maps), torch.from_numpy(labels),
                                    torch.from_numpy(sup) if sup is not None else None, NCLS, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["iou_loss"]) > 0 and float(got["cls_loss"]) > 0
    if not kw["use_l1"]:
        assert float(got["l1_loss"]) == 0.0


def test_tal_weights_match_jax():
    """The trend weights themselves (the loss only sees them normalised)."""
    _, labels, support = loss_inputs(2, empty_support=True)
    matched = np.random.RandomState(3).randint(0, 8, (2, 30))
    for gamma, thr, val in ((1.0, 0.5, 1.5), (1.5, 0.4, 1.7)):
        want = jax.vmap(lambda a, b, c: jlosses._tal_weights(a, b, c, gamma, thr, val))(
            jnp.asarray(labels), jnp.asarray(support), jnp.asarray(matched))
        got = tlosses._tal_weights(torch.from_numpy(labels), torch.from_numpy(support),
                                   torch.from_numpy(matched), gamma, thr, val)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert (got[1] == 1.0 / (1.0 + 1e-8)).all()  # empty support frame: iou 1


def assert_grads_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        bound = 1e-5 * float(np.abs(w).max()) + 1e-7
        diff = float(np.abs(g - w).max())
        assert diff <= bound, f"{what} level {i}: max |d| {diff} > {bound}"


@pytest.mark.parametrize("case", ["tal_l1", "plain_l1", "tal_empty_support"])
def test_loss_gradient_matches_jax(case):
    kw = dict(LOSS_CASES[case])
    maps, labels, support = loss_inputs(3, kw.pop("empty_support", False))
    sup = support if kw["use_tal"] else None

    def jtotal(ms):
        return jlosses.streamyolo_losses(ms, jnp.asarray(labels),
                                         jnp.asarray(sup) if sup is not None else None,
                                         NCLS, **kw)["total_loss"]

    want = jax.grad(jtotal)([jnp.asarray(m) for m in maps])
    tm = t_maps(maps, requires_grad=True)
    total = tlosses.streamyolo_losses(tm, torch.from_numpy(labels),
                                      torch.from_numpy(sup) if sup is not None else None,
                                      NCLS, **kw)["total_loss"]
    total.backward()
    got = [t.grad.numpy().transpose(0, 2, 3, 1) for t in tm]
    assert_grads_close(got, [np.asarray(w) for w in want], case)
    assert all(np.abs(g).max() > 0 for g in got)


def test_loss_ignores_autocast_dtype():
    """bf16 maps (what a model under autocast gives) are cast to float32
    before the assignment: the loss equals the float32 loss of the same
    rounded maps."""
    maps, labels, support = loss_inputs(4)
    t16 = [m.to(torch.bfloat16) for m in t_maps(maps)]
    got = tlosses.streamyolo_losses(t16, torch.from_numpy(labels), torch.from_numpy(support), NCLS)
    want = tlosses.streamyolo_losses([m.float() for m in t16], torch.from_numpy(labels),
                                     torch.from_numpy(support), NCLS)
    assert got["total_loss"].dtype == torch.float32
    for k in want:
        assert torch.equal(got[k], want[k]), k
