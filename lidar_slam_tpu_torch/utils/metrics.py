"""Evaluation metrics: trajectory ATE, relative pose error and map
agreement.

numpy copy of lidar_slam_tpu/utils/metrics.py (which the port cannot import
without JAX), with the same results for the same arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def ate_translation(est: np.ndarray, ref: np.ndarray,
                    align: bool = True) -> Dict[str, float]:
    """Absolute trajectory error of (N, 3) pose arrays (x, y, theta).

    With align=True, the estimate is first registered to the reference by
    the optimal rigid SE(2) transform (Horn/Umeyama on the xy positions) —
    the standard ATE protocol; align=False compares raw world frames.
    """
    est_xy = np.asarray(est, float)[:, :2]
    ref_xy = np.asarray(ref, float)[:, :2]
    if est_xy.shape != ref_xy.shape:
        raise ValueError(f"shape mismatch {est_xy.shape} vs {ref_xy.shape}")

    if align:
        ce, cr = est_xy.mean(0), ref_xy.mean(0)
        X = est_xy - ce
        Y = ref_xy - cr
        S = X.T @ Y
        theta = np.arctan2(S[0, 1] - S[1, 0], S[0, 0] + S[1, 1])
        c, s = np.cos(theta), np.sin(theta)
        R = np.array([[c, -s], [s, c]])
        est_xy = X @ R.T + cr

    err = np.linalg.norm(est_xy - ref_xy, axis=1)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
    }


def relative_pose_error(est: np.ndarray, ref: np.ndarray,
                        delta: int = 1) -> Dict[str, float]:
    """Relative pose error over a step of `delta` frames (odometry drift)."""
    def rel(p):
        a, b = p[:-delta], p[delta:]
        c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
        dx = b[:, 0] - a[:, 0]
        dy = b[:, 1] - a[:, 1]
        return np.stack([c * dx + s * dy, -s * dx + c * dy,
                         np.arctan2(np.sin(b[:, 2] - a[:, 2]),
                                    np.cos(b[:, 2] - a[:, 2]))], axis=1)

    d = rel(np.asarray(est, float)) - rel(np.asarray(ref, float))
    terr = np.linalg.norm(d[:, :2], axis=1)
    aerr = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
    return {
        "trans_rmse": float(np.sqrt((terr ** 2).mean())),
        "rot_rmse_deg": float(np.degrees(np.sqrt((aerr ** 2).mean()))),
    }


def map_agreement(logodds_a: np.ndarray, logodds_b: np.ndarray,
                  occ_thresh: float = 1.0) -> Dict[str, float]:
    """Cell-class agreement between two log-odds grids.

    Classes: occupied (> occ_thresh), free (< -occ_thresh), unknown.
    Reports overall accuracy and the IoU of the occupied/free classes —
    robust to the large unknown background.
    """
    a, b = np.asarray(logodds_a), np.asarray(logodds_b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")

    def cls(x):
        return np.where(x > occ_thresh, 1, np.where(x < -occ_thresh, -1, 0))

    ca, cb = cls(a), cls(b)
    out = {"accuracy": float((ca == cb).mean()),
           "logodds_mae": float(np.abs(a - b).mean())}
    for name, v in [("occupied", 1), ("free", -1)]:
        inter = ((ca == v) & (cb == v)).sum()
        union = ((ca == v) | (cb == v)).sum()
        out[f"iou_{name}"] = float(inter / union) if union else 1.0
    return out
