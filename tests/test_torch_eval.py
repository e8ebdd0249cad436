"""The offline pseudo-streaming evaluation of the PyTorch port against the JAX
package, on the CPU: the model's ``seq`` mode, the conv+BN fold, the
sequential-dedup forward, the whole evaluators, the ``Exp`` configs and the
eval CLI (``streamyolo_torch/tools/eval.py``).

Depth 0.33, width 0.25, 8 classes, fp32, at the test size 30x48 of the
textured ``write_fake_argoverse`` fixture (raw 60x96: the r = 0.5 letterbox);
JAX-initialised weights converted into the port, obj/cls prediction biases
lifted to 0 so NMS has candidates. Tolerances:

  * ``seq`` predictions and carry against the JAX ``seq``: boxes (and carried
    features) atol 1e-3, scores atol 1e-5;
  * the port's dedup forward against its dual-frame forward: the JAX
    package's first-batch guard tolerance, (1e-4, 1e-4);
  * the fused state dict against the JAX fold, converted: atol 1e-6; fused
    against unfused outputs: the ``seq`` tolerance;
  * the whole evaluation: equal image ids and categories, boxes atol 1e-3,
    scores atol 1e-5, AP and AP50 within 0.1 points.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamyolo_tpu.data import DataLoader as JDataLoader
from streamyolo_tpu.data import datasets as jdatasets
from streamyolo_tpu.data import transforms as jtransforms
from streamyolo_tpu.eval import evaluators as jevaluators
from streamyolo_tpu.eval.seq_forward import SequentialDedupForward as JSequentialDedupForward
from streamyolo_tpu.exp import get_exp as j_get_exp
from streamyolo_tpu.models import DFPPAFPN as JDFPPAFPN
from streamyolo_tpu.models import StreamYOLO as JStreamYOLO
from streamyolo_tpu.models import TALHead as JTALHead
from streamyolo_tpu.utils.fuse import fuse_model_variables
from streamyolo_torch.data import datasets as tdatasets
from streamyolo_torch.data import transforms as ttransforms
from streamyolo_torch.data.loader import DataLoader
from streamyolo_torch.eval import evaluators as tevaluators
from streamyolo_torch.eval.seq_forward import SequentialDedupForward, guard_gaps, support_shifts
from streamyolo_torch.exp import SHIPPED_CONFIGS, get_exp
from streamyolo_torch.models import DFPPAFPN, StreamYOLO, TALHead
from streamyolo_torch.tools import eval as tool
from streamyolo_torch.tools import sap_rehearsal as reh
from streamyolo_torch.utils.fuse import fuse_state_dict
from streamyolo_torch.utils.weights import jax_variables_to_state_dict

from .conftest import FAKE_IMG_SIZE
from .torch_port_helpers import (lift_pred_biases, load_port, pin_threads, randomize_bn,
                                 write_textured_argoverse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, WIDTH, NCLS = 0.33, 0.25, 8
CONF, NMS = 0.01, 0.65
DATASETS = {"ONE": "ONE_ARGOVERSEDataset", "TWO": "TWO_ARGOVERSEDataset",
            "STILL": "STILL_ARGOVERSEDataset"}


one_thread = pin_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_textured_argoverse(tmp_path_factory.mktemp("eval"), (5, 3))


@pytest.fixture(scope="module")
def models():
    jmodel = JStreamYOLO(backbone=JDFPPAFPN(DEPTH, WIDTH),
                         head=JTALHead(num_classes=NCLS, width=WIDTH))
    init = jax.jit(lambda key, x: jmodel.init(key, x, mode="off_pipe"))
    variables = lift_pred_biases(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 96, 6), jnp.float32))))
    port = load_port(StreamYOLO(DFPPAFPN(DEPTH, WIDTH), TALHead(num_classes=NCLS, width=WIDTH)),
                     variables)
    return jmodel, variables, port


def dataset_pair(root, kind):
    if kind == "STILL":
        pre = jtransforms.ValTransform(), ttransforms.ValTransform()
    else:
        pre = jtransforms.DoubleValTransform(), ttransforms.DoubleValTransform()
    return (getattr(jdatasets, DATASETS[kind])(root, "val.json", name="val",
                                               img_size=FAKE_IMG_SIZE, preproc=pre[0]),
            getattr(tdatasets, DATASETS[kind])(root, "val.json", name="val",
                                               img_size=FAKE_IMG_SIZE, preproc=pre[1]))


def padded_batches(loader, bs):
    """The loader's batches with the tail padded to ``bs`` (the evaluators' rule)."""
    for imgs, _, _, ids in loader:
        n_real = imgs.shape[0]
        if n_real < bs:
            imgs = np.concatenate([imgs, np.zeros((bs - n_real,) + imgs.shape[1:], imgs.dtype)])
        yield imgs, ids, n_real


def assert_preds_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-5, rtol=0)


def off_pipe_forward(model):
    def forward(images):
        with torch.no_grad():
            return model(torch.from_numpy(np.ascontiguousarray(images)), mode="off_pipe")
    return forward


@pytest.mark.parametrize("kind", ["ONE", "TWO"])
def test_seq_mode_matches_jax(root, models, kind):
    """Two batches of 5 (the second padded): ``seq`` predictions and the
    2-frame carry equal the JAX ``seq``'s, with the dataset's shifts."""
    jmodel, variables, port = models
    _, tds = dataset_pair(root, kind)
    shifts = support_shifts(tds)
    jcarry = tcarry = None
    n_batches = 0
    for b, (imgs, ids, n_real) in enumerate(padded_batches(DataLoader(tds, batch_size=5), 5)):
        s = np.zeros(5, np.int64)
        s[:n_real] = shifts[5 * b:5 * b + n_real]
        frames = imgs[..., :3].astype(np.float32)
        want, jcarry = jmodel.apply(variables, jnp.asarray(frames), buffer=jcarry, mode="seq",
                                    support_shift=jnp.asarray(s.astype(np.int32)))
        with torch.no_grad():
            got, tcarry = port(torch.from_numpy(frames), buffer=tcarry, mode="seq",
                               support_shift=torch.from_numpy(s))
        assert_preds_close(got.numpy(), want)
        for c, jc in zip(tcarry, jcarry):
            assert c.shape[0] == 2
            np.testing.assert_allclose(c.permute(0, 2, 3, 1).numpy(), np.asarray(jc),
                                       atol=1e-3, rtol=0)
        n_batches += 1
    assert n_batches == 2 and shifts.max() == (2 if kind == "TWO" else 1)


@pytest.mark.parametrize("kind", ["ONE", "TWO"])
def test_dedup_forward_matches_off_pipe(root, models, kind):
    """The port's dedup forward (its first-batch guard armed) against the
    port's dual-frame forward over every batch, batch 3 with a padded tail."""
    _, _, port = models
    _, tds = dataset_pair(root, kind)
    off = off_pipe_forward(port)
    dedup = SequentialDedupForward(port, tds, verify_fn=off, verify_tol=(1e-4, 1e-4))
    for imgs, ids, n_real in padded_batches(DataLoader(tds, batch_size=3), 3):
        got, want = dedup(imgs, ids)[:n_real], off(imgs)[:n_real]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    assert dedup.last_guard is not None and max(dedup.last_guard) <= 1e-4
    # after the padded tail only a reset lets the forward run again
    with pytest.raises(AssertionError, match="after a partial batch"):
        dedup(imgs, ids)
    dedup.reset()
    dedup(*next(padded_batches(DataLoader(tds, batch_size=3), 3))[:2])


def test_guard_catches_wrong_shifts(root, models):
    """Wrong wiring (every row self-fused) fails the first-batch guard."""
    _, _, port = models
    _, tds = dataset_pair(root, "ONE")
    dedup = SequentialDedupForward(port, tds, verify_fn=off_pipe_forward(port))
    dedup._shifts = np.zeros_like(dedup._shifts)
    imgs, ids, _ = next(padded_batches(DataLoader(tds, batch_size=4), 4))
    with pytest.raises(AssertionError, match="disagrees with the dual-frame forward"):
        dedup(imgs, ids)


def test_guard_fails_on_nan_and_passes_equal_infinities(root, models):
    """A NaN in the dual-frame forward's predictions fails the first-batch
    guard (a NaN gap compares false with any tolerance); the same
    infinities on both sides differ by 0."""
    _, _, port = models
    _, tds = dataset_pair(root, "ONE")
    imgs, ids, _ = next(padded_batches(DataLoader(tds, batch_size=4), 4))
    off = off_pipe_forward(port)

    def poisoned(images):
        out = off(images).clone()
        out[0, 0, 2] = float("nan")
        return out

    with pytest.raises(AssertionError, match="disagrees"):
        SequentialDedupForward(port, tds, verify_fn=poisoned)(imgs, ids)
    a = torch.tensor([[[1.0, float("inf"), 2.0, 3.0, 0.5, 0.25]]])
    b = a.clone()
    assert guard_gaps(a, b) == (0.0, 0.0)
    b[0, 0, 0] = 1.5
    b[0, 0, 5] = float("nan")
    box, score = guard_gaps(a, b)
    assert box == 0.5 and np.isnan(score)


def test_fused_state_dict_matches_jax(models):
    """``fuse_state_dict`` of the converted weights equals the converted
    JAX ``fuse_model_variables`` (BN statistics drawn from a seed)."""
    _, variables, _ = models
    variables = randomize_bn(variables, seed=5)
    want = jax_variables_to_state_dict(fuse_model_variables(variables))
    sd = jax_variables_to_state_dict(variables)
    got = fuse_state_dict(sd)
    assert got.keys() == want.keys()
    n_folded = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
        n_folded += k.endswith(".conv.weight") and not torch.equal(got[k], sd[k])
    assert n_folded == sum(k.endswith(".bn.running_var") for k in sd) > 50


def test_fused_model_matches_unfused(root, models):
    _, variables, _ = models
    variables = randomize_bn(variables, seed=5)
    plain = load_port(StreamYOLO(DFPPAFPN(DEPTH, WIDTH), TALHead(num_classes=NCLS, width=WIDTH)),
                      variables)
    fused = StreamYOLO(DFPPAFPN(DEPTH, WIDTH), TALHead(num_classes=NCLS, width=WIDTH)).eval()
    fused.load_state_dict(fuse_state_dict(plain.state_dict()))
    _, tds = dataset_pair(root, "ONE")
    imgs, ids, _ = next(padded_batches(DataLoader(tds, batch_size=4), 4))
    want = SequentialDedupForward(plain, tds)(imgs, ids)
    got = SequentialDedupForward(fused, tds)(imgs, ids)
    assert_preds_close(got.numpy(), want.numpy())


@pytest.mark.parametrize("evaluator", ["ONEX", "TWOX", "STILL"])
def test_evaluate_matches_jax(root, models, evaluator):
    """The whole evaluation, batch 3 with a padded tail: the dedup forward
    for ONEX / TWOX (the JAX one against the port's, guard armed), the
    dual-frame forward (3-channel self-duplicate) for STILL; the port's
    COCO rows and AP against the JAX evaluator's."""
    jmodel, variables, port = models
    kind = {"ONEX": "ONE", "TWOX": "TWO", "STILL": "STILL"}[evaluator]
    jds, tds = dataset_pair(root, kind)
    kw = dict(img_size=FAKE_IMG_SIZE, confthre=CONF, nmsthre=NMS, num_classes=NCLS)
    name = f"{evaluator}_COCOEvaluator"
    jev = getattr(jevaluators, name)(JDataLoader(jds, batch_size=3, shuffle=False), **kw)
    tev = getattr(tevaluators, name)(DataLoader(tds, batch_size=3), **kw)
    if evaluator == "STILL":
        off = jax.jit(lambda v, x: jmodel.apply(v, x, mode="off_pipe"))
        jfwd = lambda x: off(variables, jnp.asarray(x))  # noqa: E731
        tfwd = off_pipe_forward(port)
    else:
        jfwd = JSequentialDedupForward(jmodel, variables, jds)
        tfwd = SequentialDedupForward(port, tds, verify_fn=off_pipe_forward(port))
    (ap_j, ap50_j, _), rows_j = jev.evaluate(jfwd, return_outputs=True)
    (ap_t, ap50_t, info), rows_t = tev.evaluate(tfwd, return_outputs=True)
    assert len(rows_t) == len(rows_j) > 0
    for t, j in zip(rows_t, rows_j):
        assert (t["image_id"], t["category_id"]) == (j["image_id"], j["category_id"])
        np.testing.assert_allclose(t["bbox"], j["bbox"], atol=1e-3, rtol=0)
        assert abs(t["score"] - j["score"]) <= 1e-5
    assert abs(100 * ap_t - 100 * ap_j) <= 0.1 and abs(100 * ap50_t - 100 * ap50_j) <= 0.1
    assert "Average forward time" in info and "Average NMS time" in info
    assert np.isfinite(tev.last_stats).all()


def test_evaluate_refuses_multi_process(root, models):
    """The multi-process eval is ported (tests/test_torch_distributed.py
    runs it over two ranks); with no process group ``distributed=True``
    gathers one rank's rows, and scores as one process does."""
    _, tds = dataset_pair(root, "ONE")
    ev = tevaluators.ONEX_COCOEvaluator(DataLoader(tds, batch_size=3), FAKE_IMG_SIZE, CONF, NMS,
                                        NCLS)
    fwd = off_pipe_forward(models[2])
    (ap, ap50, info), rows = ev.evaluate(fwd, distributed=True, return_outputs=True)
    (ap1, ap50_1, _), rows1 = ev.evaluate(fwd, distributed=False, return_outputs=True)
    assert info is not None and len(rows) > 0
    assert rows == rows1 and (ap, ap50) == (ap1, ap50_1)


def test_exp_configs_match_jax():
    """Each shipped config: the port's attributes equal the JAX config's
    (but the TPU-only ``packed``), by name and by a path into ``cfgs/``,
    and ``merge`` casts overrides as the JAX one does."""
    opts = ["test_conf", "0.05", "test_size", "(320, 480)", "--nmsthre", "0.5",
            "data_num_workers", "2", "depth", "1"]
    for name in SHIPPED_CONFIGS:
        path = os.path.join(REPO, "cfgs", f"{name}.py")
        jexp, texp = j_get_exp(path), get_exp(path)
        assert get_exp(exp_name=name).exp_name == texp.exp_name == jexp.exp_name == name
        for attr in ("head_name", "dataset_name", "evaluator_name", "tal_gamma",
                     "tal_ignore_thr", "tal_ignore_value"):
            assert getattr(texp, attr) == getattr(jexp, attr), (name, attr)
        jexp.merge(opts)
        texp.merge(opts)
        want = {k: v for k, v in vars(jexp).items() if k != "packed"}
        assert vars(texp) == want, name
        assert isinstance(texp.depth, float) and texp.test_size == (320, 480)
    with pytest.raises(ValueError, match="unknown config"):
        get_exp(exp_name="x_s50_nothing")
    with pytest.raises(AttributeError):
        get_exp(exp_name=SHIPPED_CONFIGS[0]).merge(["no_such_knob", "1"])


def test_exp_builds_bf16_modules_and_warns(caplog):
    """``compute_dtype='bfloat16'`` builds bf16 modules (not only a bf16
    input); an fp32-built model behind a bf16 config warns."""
    exp = get_exp(exp_name="s_s50_onex_dfp_tal_flip").merge(["depth", "0.33", "width", "0.25"])
    exp.compute_dtype = "bfloat16"
    model = exp.get_model("cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    model.load_state_dict(exp.init_model())
    assert model.backbone.jian2.conv.weight.dtype == torch.bfloat16
    exp32 = get_exp(exp_name="s_s50_onex_dfp_tal_flip").merge(["depth", "0.33", "width", "0.25"])
    with caplog.at_level("WARNING", logger="streamyolo_torch"):
        exp.get_forward_fn(exp32.get_model("cpu"))
    assert "built fp32" in caplog.text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            exp.get_model()  # the card by default


@pytest.fixture(scope="module")
def ckpt(models, tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "weights.pth"
    torch.save(jax_variables_to_state_dict(models[1]), path)
    return str(path)


def cli(root, tmp_path, *args):
    opts = ["depth", "0.33", "width", "0.25", "test_size", "(30, 48)", "data_dir", root,
            "output_dir", str(tmp_path), "data_num_workers", "0"]
    return tool.main(["-f", os.path.join(REPO, "cfgs", "s_s50_onex_dfp_tal_flip.py"),
                      "-b", "3", "--device", "cpu", *args, *opts])


def test_eval_cli_on_cpu(root, models, ckpt, tmp_path):
    """The CLI with a ``.pth``: the dedup default and ``--no-dedup`` give the
    AP of the evaluator driven directly with the same forward; ``--fuse``
    agrees; the log lands under ``output_dir``."""
    _, _, port = models
    _, tds = dataset_pair(root, "ONE")
    ev = tevaluators.ONEX_COCOEvaluator(DataLoader(tds, batch_size=3), FAKE_IMG_SIZE, CONF,
                                        NMS, NCLS)
    ap, ap50, _ = ev.evaluate(SequentialDedupForward(port, tds))
    for extra in ([], ["--no-dedup"], ["--fuse"], ["--dedup"]):
        out = cli(root, tmp_path, "-c", ckpt, *extra)
        assert abs(out["ap"] - ap) <= 1e-3 and abs(out["ap50"] - ap50) <= 1e-3, extra
    assert os.path.isfile(tmp_path / "s_s50_onex_dfp_tal_flip" / "val_log.txt")


def test_eval_cli_speed_and_fp16(root, ckpt, tmp_path, caplog):
    with caplog.at_level("INFO", logger="streamyolo_torch"):
        out = cli(root, tmp_path, "--speed")
    assert out["speed_s_per_batch"] > 0
    assert "Params: " in caplog.text and "Gflops: " in caplog.text
    out = cli(root, tmp_path, "-c", ckpt, "--fp16", "--no-dedup")
    assert 0 <= out["ap"] <= 1


def test_eval_cli_refusals(root, ckpt, tmp_path):
    """A JAX ``.pkl``, a missing or truncated checkpoint and ``--dedup`` on a
    STILL config are refused with clear errors; ``--tolerant`` loads the
    truncated checkpoint."""
    pkl = tmp_path / "best_ckpt.pkl"
    pkl.write_bytes(b"not read")
    with pytest.raises(ValueError, match="export_safetensors"):
        cli(root, tmp_path, "-c", str(pkl))
    with pytest.raises(FileNotFoundError):
        cli(root, tmp_path, "-c", str(tmp_path / "missing.pth"))
    sd = torch.load(ckpt)
    sd.pop("head.obj_preds.0.bias")
    short = tmp_path / "short.pth"
    torch.save(sd, short)
    with pytest.raises(KeyError, match="missing"):
        cli(root, tmp_path, "-c", str(short))
    assert 0 <= cli(root, tmp_path, "-c", str(short), "--tolerant", "--no-dedup")["ap"] <= 1
    with pytest.raises(SystemExit):
        tool.main(["-n", "l_s50_still_dfp_flip", "--dedup", "--device", "cpu"])


def test_rehearsal_tool_takes_a_config(tmp_path):
    """The rehearsal tool's ``-f`` and ``key value`` overrides build the
    detector through the ``Exp``; overrides without ``-f`` are refused."""
    common = ["--out-dir", str(tmp_path), "--device", "cpu", "--in-memory", "--seqs", "1",
              "--frames", "3", "--frame-size", "128", "192", "--latency-ms", "1",
              "--conf", "1e-5", "--pgt-score-th", "1e-5"]
    summary = reh.main(common + ["-f", "cfgs/s_s50_onex_dfp_tal_flip.py",
                                 "depth", "0.33", "width", "0.25"])
    assert summary["config"] == "s_s50_onex_dfp_tal_flip"
    assert summary["frames"]["processed"] == 3 and summary["sAP"] is not None
    with pytest.raises(SystemExit):
        reh.main(common + ["depth", "0.33"])
