"""The plain reference against the port at a tiny size on the CPU, and the
frozen count against the port's own ``count_work`` at full width."""

import numpy as np
import pytest
import torch

from streambench import count, traffic, weights
from streambench.reference import judge, postprocess
from streambench.reference.model import PlainOps, StreamYOLO

DEPTH, WIDTH, CLASSES, SIZE = 0.33, 0.25, 8, (64, 96)
SEED = 5_000_000_123


@pytest.fixture(scope="module")
def models():
    from streamyolo_torch.exp import get_exp

    torch.manual_seed(0)
    exp = get_exp(exp_name="s_s50_onex_dfp_tal_flip")
    exp.depth, exp.width = DEPTH, WIDTH
    port = exp.get_model("cpu", dtype=torch.float32)
    ref = StreamYOLO(DEPTH, WIDTH, CLASSES)
    frames = traffic.frames(SEED, "test", 6, SIZE, "cpu", 16)
    state = weights.calibrated(ref, SEED, torch.device("cpu"), torch.float32, frames[:4])
    port.load_state_dict(state, strict=True)  # every name and shape of the reference's
    frames = torch.from_numpy(frames)
    return port, ref, state, frames


def _reference(ref, state, cur_frames, sup_frames):
    ops = PlainOps()
    cur = ref.pafpn(state, ops, ref.frames_in(cur_frames))
    sup = ref.pafpn(state, ops, ref.frames_in(sup_frames))
    return ref.detect(state, ops, ref.fuse(state, ops, cur, sup)), [c.shape[-2:] for c in cur]


MARGIN = 1e-4  # float32 on both sides


def _judged(rows, pred, hw):
    return judge.judge(rows, pred, [tuple(s) for s in hw], CLASSES, 0.01, 0.65, MARGIN)


def _sound(got) -> bool:
    return (got["keep_mismatch"] == 0 and got["order_breaks"] == 0
            and got["missed_candidates"] == 0 and got["selection_gap"] < MARGIN
            and got["row_gap"] < 1e-3)


def test_rows_over_a_carried_buffer(models):
    """Three consecutive steps of two cameras: the star frame, then the
    buffer carried twice."""
    from streamyolo_torch.ops.nms import postprocess_fixed

    port, ref, state, frames = models
    steps = [frames[0:2], frames[2:4], frames[4:6]]
    buf = None
    with torch.no_grad():
        for i, x in enumerate(steps):
            pred, buf = port(x, buffer=buf, mode="on_pipe")
            rows = postprocess_fixed(pred, CLASSES, 0.01, 0.65, 200).numpy()
            want, hw = _reference(ref, state, x, steps[max(i - 1, 0)])
            assert _sound(_judged(rows, want, hw)), _judged(rows, want, hw)
            ref_rows = postprocess.detections(want, CLASSES, 0.01, 0.65, 200).numpy()
            assert np.abs(ref_rows[..., 4:6] - rows[..., 4:6]).max() < 1e-4


def test_eval_rows_at_k1000(models):
    from streamyolo_torch.ops.nms import postprocess_fixed

    port, ref, state, frames = models
    x6 = torch.cat([frames[0:2], frames[2:4]], dim=-1)
    with torch.no_grad():
        rows = postprocess_fixed(port(x6, mode="off_pipe"), CLASSES, 0.01, 0.65, 1000).numpy()
        want, hw = _reference(ref, state, frames[0:2], frames[2:4])
    assert _sound(_judged(rows, want, hw)), _judged(rows, want, hw)


def test_judge_sees_a_stale_buffer(models):
    """Rows of a step fused with the wrong buffer read far off."""
    from streamyolo_torch.ops.nms import postprocess_fixed

    port, ref, state, frames = models
    with torch.no_grad():
        pred, _ = port(frames[2:4], buffer=None, mode="on_pipe")
        rows = postprocess_fixed(pred, CLASSES, 0.01, 0.65, 200).numpy()
        want, hw = _reference(ref, state, frames[2:4], frames[0:2])
    assert _judged(rows, want, hw)["row_gap"] > 0.5


def _ranked(pred, k, key, resort):
    """The reference's rows of the top ``k`` candidates by ``key`` (the
    masked score, or obj alone), optionally re-sorted by score."""
    rows, valid = postprocess.candidates(pred, CLASSES, 0.01, pred.shape[1])
    score = torch.where(valid, rows[..., 4] * rows[..., 5], torch.full_like(rows[..., 4], -1.0))
    ranking = score
    if key == "obj":
        ranking = torch.where(valid, rows[..., 4], torch.full_like(score, -1.0))
    order = torch.sort(-ranking, dim=-1, stable=True).indices[:, :k]
    if resort:
        order = order.gather(1, torch.sort(-score.gather(1, order), dim=-1, stable=True).indices)
    top = rows.gather(1, order[..., None].expand(-1, -1, rows.shape[-1]))
    keep = postprocess.greedy_keep(top, valid.gather(1, order), 0.65)
    return torch.cat([top, keep[..., None].float()], dim=-1).numpy()


@pytest.mark.parametrize("key,resort,sound", [("score", False, True), ("obj", False, False),
                                              ("obj", True, False)],
                         ids=["by score", "by obj", "by obj, served by score"])
def test_judge_sees_the_selection(models, key, resort, sound):
    """At K under the candidates' count, rows ranked by another key read as
    missed candidates, and rows out of score order as order breaks."""
    port, ref, state, frames = models
    with torch.no_grad():
        want, hw = _reference(ref, state, frames[0:2], frames[0:2])
    got = _judged(_ranked(want, 24, key, resort), want, hw)
    assert got["row_gap"] < 1e-3 and got["keep_mismatch"] == 0
    assert (got["missed_candidates"] == 0) is sound, got
    assert (got["order_breaks"] == 0) is (sound or resort), got


@pytest.mark.parametrize("config,steady_gflop", [("l_s50_onex_dfp_tal_filp", 222.97041408),
                                                  ("s_s50_onex_dfp_tal_flip", 38.42764032)])
def test_frozen_count_equals_count_work(config, steady_gflop):
    """The benchmark's count of the steady serving step at full width
    equals ``streamyolo_torch/tools/measure.py::count_work`` on meta."""
    from streamyolo_torch.exp import get_exp
    from streamyolo_torch.tools.measure import count_work, on_meta

    exp = get_exp(exp_name=config)
    meta = on_meta(exp._build().to(torch.bfloat16))
    ic = [int(c * exp.width) for c in (256, 512, 1024)]
    buf = tuple(torch.empty((1, c, h, w), dtype=torch.bfloat16, device="meta")
                for c, (h, w) in zip(ic, ((75, 120), (38, 60), (19, 30))))
    theirs = count_work(meta, torch.empty((1, 600, 960, 3), dtype=torch.uint8, device="meta"),
                        buffer=buf, mode="on_pipe")
    cfg = {"depth": exp.depth, "width": exp.width, "num_classes": 8, "dtype": "bfloat16",
           "input_size": [600, 960]}
    ours = count.count(cfg, 1, count.serve_step)
    assert ours["flops"] == theirs["flops"]
    assert ours["bytes"] == theirs["bytes"]
    assert ours["flops"] / 1e9 == pytest.approx(steady_gflop, abs=1e-6)

