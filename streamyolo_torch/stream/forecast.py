"""Forecasting meta-detector: the port's own copy of
``streamyolo_tpu/stream/forecast.py``.

  * a batched 8-state constant-velocity Kalman filter over boxes,
    x = [l, t, w, h, vl, vt, vw, vh], observing the first 4 states, with a
    dt-scaled transition and Q = dt^2 I; R = 10 I and P_init = 100 I. Tiny
    host-side 8x8 matrices in NumPy float64 (the detector is the card's
    part);
  * linear and quadratic box extrapolation with the out-of-image clean-up;
  * ``KFForecaster``: associate (``stream/track.py``), update, forecast;
  * ``Streamer``: the detector in a spawned child process connected by a
    pipe, while the parent associates the results and forecasts to any
    query time (a CUDA detector cannot live in a forked child);
  * ``forecast_results``: post-hoc forecasting over a saved streaming run.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback
from typing import Callable

import numpy as np

from streamyolo_torch.stream.bbox import ltrb2ltwh
from streamyolo_torch.stream.track import iou_assoc

# ---------------------------------------------------------------- KF core

# State layout: [l, t, w, h] then their velocities. All tracks are filtered
# at once: states are [n, 8, 1] columns, covariances [n, 8, 8], and every
# matrix op broadcasts the shared [8, 8] model over the track axis.
_DIM = 8


def _transition(dt: float) -> np.ndarray:
    """Constant velocity: each box coordinate drifts by dt * its velocity."""
    A = np.eye(_DIM)
    A[np.arange(4), np.arange(4, 8)] = dt
    return A


def _drift_noise(dt: float) -> np.ndarray:
    """Isotropic process noise growing with the prediction horizon."""
    return (dt * dt) * np.eye(_DIM)


def _as_states(boxes_ltwh: np.ndarray) -> np.ndarray:
    """[n, 4] boxes -> [n, 8, 1] zero-velocity states."""
    b = np.asarray(boxes_ltwh, np.float64)
    return np.concatenate((b, np.zeros_like(b)), axis=1)[:, :, None]


def _boxes_of(states: np.ndarray) -> np.ndarray:
    """[n, 8, 1] states -> [n, 4] ltwh boxes."""
    return states[:, :4, 0]


def _kf_time_step(A, Q, states, covs):
    """Batched predict: x' = A x, P' = A P A^T + Q."""
    return A @ states, A @ covs @ A.T + Q


def _kf_correct(states, covs, observations, R):
    """Batched measurement update with H = [I_4 0] (positions observed,
    velocities never): gain K = P[:, :, :4] (P[:, :4, :4] + R)^-1."""
    innovation = observations - states[:, :4]
    gain = covs[:, :, :4] @ np.linalg.inv(covs[:, :4, :4] + R)
    return states + gain @ innovation, covs - gain @ covs[:, :4]


# ------------------------------------------------------------ extrapolation


def extrap_clean_up(bboxes, w_img, h_img, min_size: int = 75, lt: bool = False):
    """Clip extrapolated boxes to the image and drop degenerate and small
    ones. Input [n, 4] cxcywh (ltwh if ``lt``); returns (ltwh boxes kept,
    keep mask)."""
    bboxes = np.asarray(bboxes, np.float64).copy()
    keep = (bboxes[:, 2] > 0) & (bboxes[:, 3] > 0)
    if lt:
        bboxes[:, 2:] = bboxes[:, :2] + bboxes[:, 2:]
    else:
        bboxes[:, :2] = bboxes[:, :2] - bboxes[:, 2:] / 2
        bboxes[:, 2:] = bboxes[:, :2] + bboxes[:, 2:]
    bboxes[:, [0, 2]] = bboxes[:, [0, 2]].clip(0, w_img)
    bboxes[:, [1, 3]] = bboxes[:, [1, 3]].clip(0, h_img)
    bboxes[:, 2:] = bboxes[:, 2:] - bboxes[:, :2]
    keep &= bboxes[:, 2].astype(int) * bboxes[:, 3].astype(int) >= min_size
    return bboxes[keep], keep


def bbox_extrap_lin(bboxes1, bboxes2, tk, w_img, h_img, min_size=75):
    """Linear extrapolation of ltwh boxes ``tk`` steps past ``bboxes2``."""
    bboxes2 = np.asarray(bboxes2)
    bboxes3 = bboxes2 + tk * (bboxes2 - np.asarray(bboxes1))
    return extrap_clean_up(bboxes3, w_img, h_img, min_size, lt=True)


def bbox_extrap_quad(bboxes1, bboxes2, v1, v2, tk, t32, w_img, h_img, min_size=75):
    """Quadratic (velocity-aware) extrapolation: the first ``len(v1)`` boxes
    move by their extrapolated velocity over ``t32``, the rest linearly."""
    n_v1, n_v2 = len(v1), len(v2)
    if n_v1 == 0 or n_v2 == 0:
        return bbox_extrap_lin(bboxes1, bboxes2, tk, w_img, h_img, min_size)
    v2 = np.asarray(v2)[:n_v1]
    v3 = v2 + tk * (v2 - np.asarray(v1))
    bboxes1 = np.array(bboxes1, np.float64)
    bboxes2 = np.array(bboxes2, np.float64)
    bboxes1[:, :2] += bboxes1[:, 2:] / 2
    bboxes2[:, :2] += bboxes2[:, 2:] / 2
    bboxes3 = bboxes2[:n_v1] + v3 * t32
    if len(bboxes1) > n_v1:
        tail = bboxes2[n_v1:] + tk * (bboxes2[n_v1:] - bboxes1[n_v1:])
        bboxes3 = np.vstack((bboxes3, tail))
    return extrap_clean_up(bboxes3, w_img, h_img, min_size)


# ------------------------------------------------------------ KF forecaster


class KFForecaster:
    """A stateful track set: associate new detections, Kalman-update the
    matched tracks, start new ones, and forecast every box to any time."""

    def __init__(self, match_iou_th: float = 0.3, R_scale: float = 10.0,
                 P_init_scale: float = 100.0):
        self.match_iou_th = match_iou_th
        self.R = R_scale * np.eye(4)
        self.P_init_scale = P_init_scale
        self.reset()

    def reset(self):
        self.x = np.zeros((0, 8, 1))
        self.P = np.zeros((0, 8, 8))
        self.tracks = np.zeros(0, np.int64)
        self.labels = np.zeros(0, np.int64)
        self.scores = np.zeros(0)
        self.tkidx = 0
        self.last_t = None

    def _fresh_covs(self, n: int) -> np.ndarray:
        return np.tile(self.P_init_scale * np.eye(_DIM), (n, 1, 1))

    def update(self, t: float, bboxes_ltwh, scores, labels):
        """Ingest the detections made from the frame at time ``t``."""
        bboxes_ltwh = np.asarray(bboxes_ltwh, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.asarray(labels, np.int64).reshape(-1)

        if len(self.tracks) and self.last_t is not None:
            dt = t - self.last_t
            self.x, self.P = _kf_time_step(_transition(dt), _drift_noise(dt), self.x, self.P)

        if len(self.tracks) == 0:
            self.x = _as_states(bboxes_ltwh)
            self.P = self._fresh_covs(len(bboxes_ltwh))
            self.tracks = np.arange(len(bboxes_ltwh), dtype=np.int64)
            self.labels = labels
            self.scores = scores
            self.tkidx = len(bboxes_ltwh)
        else:
            order1, order2, n_matched, tracks2, self.tkidx = iou_assoc(
                _boxes_of(self.x), self.labels, self.tracks, self.tkidx,
                bboxes_ltwh, labels, self.match_iou_th)
            x, P = self.x[order1], self.P[order1]
            new_boxes = bboxes_ltwh[order2]
            if n_matched:
                x_m, P_m = _kf_correct(x[:n_matched], P[:n_matched],
                                       new_boxes[:n_matched, :, None], self.R)
            else:
                x_m, P_m = x[:0], P[:0]
            self.x = np.concatenate((x_m, _as_states(new_boxes[n_matched:])))
            self.P = np.concatenate((P_m, self._fresh_covs(len(new_boxes) - n_matched)))
            self.tracks = tracks2
            self.labels = labels[order2]
            self.scores = scores[order2]
        self.last_t = t

    def forecast(self, t_query: float, w_img: int, h_img: int, min_size: int = 75):
        """Every live track's box at ``t_query``, cleaned up: (ltwh boxes,
        scores, labels, track ids)."""
        if len(self.tracks) == 0 or self.last_t is None:
            return (np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        x_pred = _transition(t_query - self.last_t) @ self.x
        bboxes, keep = extrap_clean_up(_boxes_of(x_pred), w_img, h_img, min_size, lt=True)
        return bboxes, self.scores[keep], self.labels[keep], self.tracks[keep]


# ------------------------------------------------------------ Streamer


def _det_process(make_detect_fn, conn):
    """Child process: build the detector, then serve (fidx, frame) ->
    parsed detections over the pipe; a failure is sent to the parent with
    its traceback instead of dying silently."""
    try:
        detect = make_detect_fn()
        conn.send("ready")
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fidx, frame = msg
            conn.send((fidx, detect(frame)))
    except Exception:  # the child's boundary: report, then end
        conn.send(("__error__", traceback.format_exc()))


class Streamer:
    """The detector in a spawned child process, and the Kalman forecaster in
    the parent. The parent never blocks on the detector: it polls the pipe,
    folds finished detections into the track set, and can forecast to any
    query time in between.

    ``make_detect_fn`` runs in the child and returns ``detect(frame) ->
    (bboxes_ltrb, scores, labels, ...)``; the child is spawned, so
    ``make_detect_fn`` must pickle by reference (a top-level function, or a
    ``functools.partial`` of one)."""

    def __init__(self, make_detect_fn: Callable[[], Callable],
                 match_iou_th: float = 0.3):
        ctx = mp.get_context("spawn")
        self._parent_conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(target=_det_process, args=(make_detect_fn, child_conn),
                                 daemon=True)
        self._proc.start()
        child_conn.close()
        try:
            ready = self._recv()
            if ready != "ready":
                raise RuntimeError(f"detector process sent {ready!r} instead of 'ready'")
        except RuntimeError:
            self.close()
            raise
        self.forecaster = KFForecaster(match_iou_th=match_iou_th)
        self.last_result = None  # the detector's latest result, as it was sent
        self._in_flight = False
        self._t_sent = None

    def _recv(self):
        try:
            msg = self._parent_conn.recv()
        except EOFError as e:
            raise RuntimeError("detector process ended without a reply") from e
        if isinstance(msg, tuple) and msg and msg[0] == "__error__":
            self._in_flight = False
            raise RuntimeError(f"detector process failed:\n{msg[1]}")
        return msg

    def submit(self, fidx: int, frame, t_sent: float) -> bool:
        """Send a frame to the detector if it is idle; returns whether it
        was sent. ``t_sent`` is the frame's time."""
        if self._in_flight:
            return False
        self._t_sent = t_sent
        self._parent_conn.send((fidx, frame))
        self._in_flight = True
        return True

    def poll(self, timeout: float = 0.0):
        """Fold a finished detection into the track set if one is there,
        stamped with its frame's submission time (the boxes describe the
        world at that frame). Returns its frame index, or None."""
        if self._in_flight and self._parent_conn.poll(timeout):
            fidx, result = self._recv()
            self._in_flight = False
            self.last_result = result
            bboxes, scores, labels = result[:3]
            if len(bboxes):
                self.forecaster.update(self._t_sent, ltrb2ltwh(np.asarray(bboxes)),
                                       scores, labels)
            return fidx
        return None

    def forecast(self, t_query: float, w_img: int, h_img: int):
        return self.forecaster.forecast(t_query, w_img, h_img)

    def close(self):
        try:
            self._parent_conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)
        self._parent_conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def forecast_results(db, results_by_seq, fps: float = 30.0, eta: int = 0,
                     match_iou_th: float = 0.3, min_size: int = 75):
    """Post-hoc Kalman forecasting over a saved streaming run: replay each
    sequence's timestamped detections through the association and the
    filter (each stamped with its INPUT frame's time) and, at every ground
    truth frame's query time, emit the tracks' boxes forecast to that time
    instead of the last output. Returns (results_ccf, {"miss": n}), the
    pairing pass's contract, so the result feeds ``eval_ccf``."""
    results_ccf = []
    miss = 0
    for sid, seq in enumerate(db.dataset["sequences"]):
        frame_list = [img for img in db.imgs.values() if img["sid"] == sid]
        results = results_by_seq[seq]
        parsed = results["results_parsed"]
        timestamps = results["timestamps"]
        input_fidx = results["input_fidx"]

        f = KFForecaster(match_iou_th=match_iou_th)
        tidx = 0
        for ii, img in enumerate(frame_list):
            t_query = (ii - eta) / fps
            while tidx < len(timestamps) and timestamps[tidx] <= t_query:
                bboxes, scores, labels = parsed[tidx][:3]
                if len(bboxes):
                    f.update(input_fidx[tidx] / fps, ltrb2ltwh(np.asarray(bboxes)),
                             scores, labels)
                tidx += 1
            if f.last_t is None:
                miss += 1
                continue
            bboxes_ltwh, scores, labels, _ = f.forecast(
                t_query, img["width"], img["height"], min_size=min_size)
            for i in range(len(bboxes_ltwh)):
                results_ccf.append({
                    "image_id": img["id"],
                    "bbox": [float(v) for v in bboxes_ltwh[i]],
                    "score": float(scores[i]),
                    "category_id": int(labels[i]),
                })
    return results_ccf, {"miss": miss}
