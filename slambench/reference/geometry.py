"""SE(2) algebra, scan conversion and wheel odometry, written plainly.

Poses are (..., 3) tensors (x, y, yaw); transforms are (..., 3, 3)
matrices. Every contraction of the reference (products of transforms, of
points by rotations, the cross terms of distances, covariances) goes
through mm(), which inside `with tf32():` rounds its operands to TF32
(10 explicit mantissa bits) and accumulates in the operands' dtype, as
the card's TF32 tensor cores do: the control's precision, applied the same
whatever kernel the library picks for a small product.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_ROUND = [False]


@contextlib.contextmanager
def tf32():
    """Contractions of the reference in TF32 inside the block."""
    _ROUND.append(True)
    try:
        yield
    finally:
        _ROUND.pop()


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 11 significant bits (to nearest), with x's
    gradient (the rounding is not differentiated)."""
    m, e = torch.frexp(x)
    return x + (torch.ldexp(torch.round(m * 2048.0) / 2048.0, e) - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, in TF32 inside `with tf32():`."""
    if _ROUND[-1]:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def T_of(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3) poses -> (..., 3, 3) SE(2) matrices."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, pose[..., 0]], -1),
                        torch.stack([s, c, pose[..., 1]], -1),
                        torch.stack([z, z, o], -1)], -2)


def pose_of(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) SE(2) matrices -> (..., 3) poses, yaw in (-pi, pi]."""
    return torch.stack([T[..., 0, 2], T[..., 1, 2],
                        torch.atan2(T[..., 1, 0], T[..., 0, 0])], dim=-1)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse of (..., 3, 3) SE(2) matrices."""
    R = T[..., :2, :2].transpose(-1, -2)
    t = -mm(R, T[..., :2, 2:])
    bottom = torch.zeros_like(T[..., 2:, :])
    bottom = torch.cat([bottom[..., :2], torch.ones_like(bottom[..., 2:])],
                       dim=-1)
    return torch.cat([torch.cat([R, t], dim=-1), bottom], dim=-2)


def wrap(a):
    """Angles wrapped to (-pi, pi] (tensors or numpy arrays)."""
    if isinstance(a, torch.Tensor):
        return torch.atan2(torch.sin(a), torch.cos(a))
    return np.arctan2(np.sin(a), np.cos(a))


def log_se2(T: torch.Tensor) -> torch.Tensor:
    """SE(2) logarithm (GTSAM's Pose2::Logmap): (..., 3, 3) -> (..., 3)."""
    w = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    tx, ty = T[..., 0, 2], T[..., 1, 2]
    small = torch.abs(w) < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(ws) / ws)
    b = torch.where(small, w / 2.0, (1.0 - torch.cos(ws)) / ws)
    den = a * a + b * b
    return torch.stack([(a * tx + b * ty) / den, (-b * tx + a * ty) / den, w],
                       dim=-1)


def scan_points(ranges: torch.Tensor, range_min: float, range_max: float,
                angle_min: float, angle_max: float, p_rl) -> tuple:
    """(N, R) ranges -> robot-frame points (N, R, 2) and validity (N, R).

    A ray is valid when range_min <= r <= range_max. Points are the polar
    readings in the lidar frame plus the lidar's offset p_rl (no rotation);
    an invalid ray sits at p_rl."""
    n = ranges.shape[-1]
    ang = torch.linspace(angle_min, angle_max, n, dtype=torch.float64,
                         device=ranges.device).to(ranges.dtype)
    valid = (ranges >= range_min) & (ranges <= range_max)
    r = torch.where(valid, ranges, torch.zeros_like(ranges))
    pts = torch.stack([r * torch.cos(ang) + p_rl[0],
                       r * torch.sin(ang) + p_rl[1]], dim=-1)
    return pts, valid


def encoder_speed(counts, dist_per_tick: float, freq: float):
    """Forward speed from encoder counts [FR, FL, RR, RL]: the mean of the
    right and left wheels' distances a period, times the rate."""
    right = (counts[..., 0] + counts[..., 2]) / 2 * dist_per_tick
    left = (counts[..., 1] + counts[..., 3]) / 2 * dist_per_tick
    return (right + left) / 2 * freq


def odometry(counts: np.ndarray, gyro: np.ndarray, dist_per_tick: float,
             freq: float, x0=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Dead-reckoned poses (N, 3), float64, one step at a time: step t
    moves by encoder row t and gyro row t with the sinc-corrected
    differential-drive model (a chord along the mid-step heading)."""
    counts = np.asarray(counts, np.float64)
    gyro = np.asarray(gyro, np.float64)
    dt = 1.0 / freq
    v = encoder_speed(counts, dist_per_tick, freq)
    poses = np.zeros((counts.shape[0], 3))
    poses[0] = x0
    for t in range(1, counts.shape[0]):
        x, y, th = poses[t - 1]
        dth = gyro[t, 2] * dt
        h = dth / 2.0
        sinc = 1.0 - h * h / 6.0 if abs(h) < 1e-8 else math.sin(h) / h
        k = v[t] * dt * sinc
        poses[t] = (x + k * math.cos(th + h), y + k * math.sin(th + h),
                    th + dth)
    return poses


def pose_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row, |translation difference| in metres plus |yaw difference|
    in radians (one radian weighed as one metre) of (..., 3) poses."""
    dxy = torch.linalg.vector_norm(a[..., :2] - b[..., :2], dim=-1)
    return dxy + torch.abs(wrap(a[..., 2] - b[..., 2]))


def gap_stats(name: str, gaps: torch.Tensor) -> dict:
    """The widest, the 99th-percentile and the median of per-item gaps, as
    name, name_p99 and name_median."""
    q = torch.quantile(gaps, torch.tensor([0.99, 0.5], dtype=gaps.dtype,
                                          device=gaps.device))
    return {name: float(gaps.max()), name + "_p99": float(q[0]),
            name + "_median": float(q[1])}
