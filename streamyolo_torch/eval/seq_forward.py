"""Sequential-dedup eval forward: one backbone pass per unique frame, the
counterpart of ``streamyolo_tpu/eval/seq_forward.py``.

The dual-frame (``off_pipe``) eval runs the backbone+PAFPN on both halves of
every 6-channel sample, but on a sequential video sample i's support frame
IS an earlier sample's current frame. ``SequentialDedupForward`` runs the
model's ``mode='seq'`` instead: one batched pafpn pass over the current
frames, the support features gathered from the batch's own outputs, with
the previous batch's last two frames carried on the device. The per-row
shift encodes the dataset's pairing rule (ONE: t-1, 0 at boundaries; TWO:
t-2, degrading to 1 or 0). BN uses running statistics, so the outputs are
those of the dual-frame forward at half the backbone work.

Needs the val loader to walk the dataset in order, unsharded (shuffle off,
one process).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from streamyolo_torch.data.datasets import TWO_ARGOVERSEDataset
from streamyolo_torch.utils.logger import get_logger


def support_shifts(dataset) -> np.ndarray:
    """Per-dataset-index support shift s (support frame = frame idx - s),
    the ``_load_anno_from_id`` boundary rules of the dataset."""
    images = dataset.coco.dataset["images"]
    n = len(dataset.ids)
    two = isinstance(dataset, TWO_ARGOVERSEDataset)
    shifts = np.zeros(n, np.int32)
    for idx, id_ in enumerate(dataset.ids):
        i = int(id_)
        if two:
            if images[i]["fid"] == 0:
                s = 0
            elif images[i]["fid"] == 1:
                s = 1
            elif i == n - 1:
                s = 0
            elif i + 1 == n - 1:
                s = 1
            elif images[i + 1]["fid"] == 0:
                s = 0
            elif images[i + 2]["fid"] == 0:
                s = 1
            else:
                s = 2
        else:
            if images[i]["fid"] == 0 or i == n - 1 or images[i + 1]["fid"] == 0:
                s = 0
            else:
                s = 1
        shifts[idx] = s
    return shifts


@contextlib.contextmanager
def per_image_convolution(device: torch.device):
    """cuDNN off on a card: PyTorch's own convolution, one GEMM per image of
    the batch, so that an image rounds alike at every batch row and in every
    batch (cuDNN's split-K kernels round an image by its row,
    ``tools/row_invariance.py``, and which kernel it picks depends on the
    batch). The eval forwards run under it, so that the dedup eval's rows
    equal the dual-frame eval's."""
    if device.type != "cuda":
        yield
        return
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def guard_gaps(got: torch.Tensor, want: torch.Tensor):
    """(max box gap in px, max score gap) of two decoded ``[B, N, 5+C]``
    predictions: equal entries (infinities included) differ by 0, and a NaN
    on either side gives a NaN gap, which no tolerance passes."""
    got, want = got.float(), want.float()
    diff = torch.where(got == want, 0.0, (got - want).abs())
    return float(diff[..., :4].max()), float(diff[..., 4:].max())


class SequentialDedupForward:
    """``forward_fn`` for the evaluators: it advertises ``needs_ids``, so the
    evaluator passes the batch's image ids; padded tail rows self-fuse and
    are sliced off downstream.

    ``verify_fn`` (the dual-frame forward on the same model) arms a
    first-batch guard: the first batch also runs dual-frame, and the
    decoded predictions must agree within ``verify_tol`` = (box pixels,
    scores). The first batch holds the boundary rows (fid 0 self-support),
    so a wiring fault (wrong shifts, a stale carry) shows there.

    On a card every batch runs with cuDNN off (``per_image_convolution``),
    as the dual-frame forward of ``StreamExp.get_forward_fn`` does. The
    dual-frame forward computes a support frame at another batch row than
    the dedup forward does, and cuDNN's split-K kernels round an image by
    its row (``tools/row_invariance.py``), which a deep trunk carries past
    the bf16 bound: under cuDNN, later batches moved rows by up to 1.75 px
    and 0.047 in score on trained weights (ROADMAP C.1). PyTorch's own
    convolution runs one GEMM per image, so an image rounds alike at every
    row and in every batch, and the two evals' rows are equal."""

    needs_ids = True

    def __init__(self, model: torch.nn.Module, dataset,
                 verify_fn: Optional[Callable[[np.ndarray], torch.Tensor]] = None,
                 verify_tol: Tuple[float, float] = (1e-4, 1e-4)):
        self._model = model
        self._device = next(model.parameters()).device
        self._shifts = support_shifts(dataset)
        self._id_to_idx = {int(v): k for k, v in enumerate(dataset.ids)}
        self._carry = None
        self._saw_partial = False
        self._verify_fn = verify_fn
        self._verify_tol = verify_tol
        self.last_guard = None  # (box_diff, score_diff) of the first-batch guard

    def reset(self):
        self._carry = None
        self._saw_partial = False

    @torch.inference_mode()
    def __call__(self, images: np.ndarray, ids) -> torch.Tensor:
        n_real = len(ids)
        # Padded rows (shift 0) of a partial batch enter the 2-frame carry; that
        # is only right at the dataset tail, so a batch after a partial one is
        # refused.
        if self._saw_partial:
            raise AssertionError(
                "SequentialDedupForward received a batch after a partial batch; "
                "partial batches are only valid at the dataset tail (call reset() "
                "between epochs)")
        if n_real < images.shape[0]:
            self._saw_partial = True
        shifts = np.zeros(images.shape[0], np.int64)  # padded rows self-fuse
        shifts[:n_real] = [
            self._shifts[self._id_to_idx[int(np.asarray(i).reshape(-1)[0])]] for i in ids]
        # the whole uint8 batch crosses and the current frames are sliced on
        # the device: a host copy of the strided 3-channel slice costs more
        # than the extra bytes
        frames = torch.from_numpy(images).to(self._device)[..., :3].contiguous()
        with per_image_convolution(self._device):
            preds, self._carry = self._model(
                frames, buffer=self._carry, mode="seq",
                support_shift=torch.from_numpy(shifts).to(self._device))
        if self._verify_fn is not None:
            self._assert_first_batch_parity(images, preds, n_real)
            self._verify_fn = None
        return preds

    def _assert_first_batch_parity(self, images, preds, n_real: int):
        """Run the dual-frame forward on the same batch and compare the box
        and score channels of the real rows (``guard_gaps``); a NaN on
        either side fails the guard."""
        box_tol, score_tol = self._verify_tol
        box_diff, score_diff = guard_gaps(preds[:n_real], self._verify_fn(images)[:n_real])
        self.last_guard = (box_diff, score_diff)
        if not (box_diff <= box_tol and score_diff <= score_tol):
            raise AssertionError(
                "sequential-dedup eval disagrees with the dual-frame forward "
                f"on the first batch: max box diff {box_diff:.3e} px (tol "
                f"{box_tol:g}), max score diff {score_diff:.3e} (tol "
                f"{score_tol:g}). The dedup carry/shift wiring does not "
                "match this dataset's pairing; rerun with --no-dedup and "
                "report the config.")
        get_logger().info(
            "dedup parity check passed on the first batch: max box diff "
            f"{box_diff:.2e} px, max score diff {score_diff:.2e}")
