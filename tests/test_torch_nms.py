"""NMS and the fixed-shape postprocess of the PyTorch port against the JAX
package. Keep masks and class ids must match exactly; the float payload of
the [K, 8] rows to atol 1e-5 (it is the same float32 values gathered, so in
practice it is exact too).

The JAX side runs its Pallas kernel in interpret mode, as its own tests do.
Tests of kernel B1 itself need the card (``-m cuda``) and skip here; the
arithmetic of its division-free threshold test is checked on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamyolo_tpu.ops import nms as jnms
from streamyolo_tpu.ops.nms_pallas import nms_padded_pallas
from streamyolo_torch.ops import nms as tnms
from streamyolo_torch.ops.nms_cuda import nms_keep

from .torch_port_helpers import pin_threads, require_cuda

CLASS_OFFSET = 8192.0


one_thread = pin_threads(1)


def selftest_case(k, seed, ties=False):
    """The inputs of ``run_pallas_nms_selftest``: score-sorted boxes with 3
    class offsets, 80 % valid; ``ties`` makes groups of 4 equal-score boxes
    sorted stably (so duplicates sit next to each other)."""
    rng = np.random.RandomState(seed)
    cxy = rng.uniform(20, 500, (k, 2))
    wh = rng.uniform(5, 80, (k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    if ties:
        scores = np.repeat(rng.uniform(0.2, 1.0, k // 4), 4)
        boxes = boxes[np.argsort(-scores, kind="stable")]
    boxes += rng.randint(0, 3, (k, 1)) * CLASS_OFFSET
    valid = rng.uniform(size=k) < 0.8
    return boxes.astype(np.float32), valid


@pytest.mark.parametrize("k,thr,ties", [
    (64, 0.45, False), (64, 0.65, False), (200, 0.45, False), (200, 0.65, False),
    (64, 0.5, True),
])
def test_plain_nms_bit_equal_to_jax(k, thr, ties):
    boxes, valid = selftest_case(k, seed=k, ties=ties)
    jb, jv = jnp.asarray(boxes), jnp.asarray(valid)
    want = np.asarray(nms_padded_pallas(jb, jv, thr, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jnms.nms_padded(jb, jv, thr)))
    np.testing.assert_array_equal(want, np.asarray(jnms.nms_padded_sequential(jb, jv, thr)))
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    np.testing.assert_array_equal(tnms.nms_padded(tb, tv, thr).numpy(), want)
    np.testing.assert_array_equal(tnms.nms_padded_sequential(tb, tv, thr).numpy(), want)
    # the wrapper's CPU path (batched): the plain fixed point, no launch
    before = nms_keep.launches
    np.testing.assert_array_equal(nms_keep(tb[None], tv[None], thr)[0].numpy(), want)
    assert nms_keep.launches == before


def random_predictions(rng, b, n, ncls=8, size=160.0):
    """Decoded [B, N, 5+C] predictions with some exact score ties."""
    cxy = rng.uniform(0, size, (b, n, 2))
    wh = rng.uniform(4, 40, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.uniform(0, 1, (b, n, ncls))
    pred = np.concatenate([cxy, wh, obj, cls], -1).astype(np.float32)
    pred[:, 1::7, 4:] = pred[:, ::7, 4:][:, : pred[:, 1::7].shape[1]]  # ties
    return pred


@pytest.mark.parametrize("n,topk,agnostic", [(300, 100, False), (120, 200, False),
                                             (300, 100, True)])
def test_postprocess_fixed_rows_match_jax(rng, n, topk, agnostic):
    pred = random_predictions(rng, 2, n)
    want = np.asarray(jnms.postprocess_fixed(
        jnp.asarray(pred), 8, 0.05, 0.45, topk, agnostic, use_pallas=False))
    got = tnms.postprocess_fixed(torch.from_numpy(pred), 8, 0.05, 0.45, topk, agnostic).numpy()
    assert got.shape == want.shape == (2, min(topk, n), 8)
    np.testing.assert_array_equal(got[..., 6:8], want[..., 6:8])  # cls, keep
    np.testing.assert_allclose(got[..., :6], want[..., :6], atol=1e-5, rtol=0)
    assert want[..., 7].sum() > 0  # NMS kept something


def test_postprocess_list_and_saturation_match_jax():
    """The dense scene of tests/test_nms.py: 1600 above-conf candidates; the
    1000 cap saturates and is detected; K covering N is not saturation."""
    n_cells, ncls = 800, 8
    gx, gy = np.meshgrid(np.arange(40), np.arange(20))
    centers = np.stack([gx.reshape(-1) * 24 + 12, gy.reshape(-1) * 24 + 12], -1)
    preds = []
    for j, (cx, cy) in enumerate(centers[:n_cells]):
        hi, lo = 0.9 - 1e-4 * j, 0.5 - 1e-4 * j
        cls = np.zeros(ncls)
        cls[j % ncls] = 1.0
        preds.append([cx, cy, 10, 10, hi, *cls])
        preds.append([cx + 1, cy + 1, 10, 10, lo, *cls])
    pred = np.asarray(preds, np.float32)[None]

    for topk, saturated in ((1000, 1), (1600, 0)):
        want = np.asarray(jnms.postprocess_fixed(
            jnp.asarray(pred), ncls, 0.001, 0.65, topk, use_pallas=False))
        got = tnms.postprocess_fixed(torch.from_numpy(pred), ncls, 0.001, 0.65, topk).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tnms.candidate_counts(got, 0.001),
                                      jnms.candidate_counts(want, 0.001))
        assert tnms.warn_if_saturated(got, 0.001, pred.shape[1]) == saturated
    for a, b in zip(tnms.postprocess(pred, ncls, 0.001, 0.65, 1000),
                    jnms.postprocess(pred, ncls, 0.001, 0.65, 1000)):
        np.testing.assert_array_equal(a, b)
    empty = np.zeros((1, 10, 13), np.float32)
    assert tnms.postprocess(empty, ncls, 0.5, 0.65) == [None]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 200, 1024])
def test_nms_kernel_matches_plain_on_card(k):
    require_cuda()
    for thr in (0.45, 0.65):
        cases = [selftest_case(k, seed=s) for s in range(8)]
        boxes = torch.from_numpy(np.stack([c[0] for c in cases])).cuda()
        valid = torch.from_numpy(np.stack([c[1] for c in cases])).cuda()
        before = nms_keep.launches
        got = nms_keep(boxes, valid, thr)
        torch.cuda.synchronize()
        assert nms_keep.launches == before + 1
        want = tnms.nms_padded_sequential(boxes.cpu(), valid.cpu(), thr)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        np.testing.assert_array_equal(
            tnms.nms_padded(boxes, valid, thr).cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_nms_kernel_rejects_bad_input():
    require_cuda()
    boxes = torch.zeros(1, 8, 4, device="cuda")
    valid = torch.ones(1, 8, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        nms_keep(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        nms_keep(torch.zeros(1, 1025, 4, device="cuda"),
                 torch.ones(1, 1025, dtype=torch.bool, device="cuda"), 0.5)
    with pytest.raises(ValueError):  # a view that is not contiguous
        nms_keep(torch.zeros(1, 8, 8, device="cuda")[..., :4], valid, 0.5)


def edge_case(name):
    """(boxes [B, K, 4], valid [B, K], thr) of the kernel's edge cases: K at
    the edges of its 32-row chunks, no valid box, 200 identical boxes (one
    keeper, the longest suppression) and the multi-stream batch of 56."""
    k, b = {"k1": (1, 8), "k31": (31, 8), "k33": (33, 8), "k1024": (1024, 8),
            "all_invalid": (200, 8), "all_identical": (200, 8), "batch56": (200, 56)}[name]
    cases = [selftest_case(k, seed=1000 * k + s) for s in range(b)]
    boxes, valid = np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases])
    if name == "all_invalid":
        valid[:] = False
    if name == "all_identical":
        boxes[:] = boxes[:, :1]
        valid[:] = True
    return boxes, valid, 0.65


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k1", "k31", "k33", "k1024", "all_invalid", "all_identical",
                                  "batch56"])
def test_nms_kernel_edge_cases_on_card(name):
    require_cuda()
    boxes, valid, thr = edge_case(name)
    boxes, valid = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
    got = nms_keep(boxes, valid, thr).cpu()
    want = tnms.nms_padded_sequential(boxes.cpu(), valid.cpu(), thr)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(tnms.nms_padded(boxes, valid, thr).cpu().numpy(), want.numpy())
    if name == "all_identical":
        assert got[:, 0].all() and not got[:, 1:].any()
    if name == "all_invalid":
        assert not got.any()


@pytest.mark.parametrize("thr", [0.45, 0.5, 0.65, 0.0, 1e-40, 2e-40])
def test_division_free_threshold_matches_divide(thr):
    """Kernel B1 decides ``fl(inter / u) > thr`` without the divide: the
    quotient rounds above thr exactly when ``inter > mid * u``, mid halfway
    between thr and the next float up (exact in double), or on it when that
    next float is even. Held against the float32 divide on random pairs, on
    pairs next to the boundary and on exact ties (subnormal thresholds)."""
    rng = np.random.default_rng(0)
    t = np.float32(thr)
    up = np.nextafter(t, np.float32(np.inf))
    mid = (np.float64(t) + np.float64(up)) / 2
    tie_up = (up.view(np.uint32) & 1) == 0
    u = rng.uniform(1e-3, 1e5, 100_000).astype(np.float32)
    near = (mid * u.astype(np.float64)).astype(np.float32)
    pow2 = np.float32(2.0) ** np.arange(1, 40, dtype=np.float32)
    inter = np.concatenate([near, np.nextafter(near, np.float32(0)),
                            np.nextafter(near, np.float32(np.inf)),
                            rng.uniform(0, 1e5, 100_000).astype(np.float32),
                            (mid * pow2.astype(np.float64)).astype(np.float32)])
    u = np.concatenate([u, u, u, u, pow2])
    with np.errstate(under="ignore"):
        want = (inter / u) > t  # float32 divide, round to nearest even
    a, p = inter.astype(np.float64), mid * u.astype(np.float64)
    got = (a > p) | (tie_up & (a == p) & np.isfinite(inter))
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
