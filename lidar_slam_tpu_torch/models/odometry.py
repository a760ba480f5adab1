"""Differential-drive dead-reckoning odometry as three prefix sums.

Counterpart of lidar_slam_tpu/models/odometry.py: yaw is a cumsum of the
gyro increments, and once every step's midpoint heading is known the
sinc-corrected position increments are independent, so the trajectory is
three cumsums plus elementwise math instead of a sequential loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import RobotConfig
from ..utils import se2

DIST_PER_TICK = RobotConfig().dist_per_tick
FREQ = RobotConfig().encoder_freq


def v_from_encoder(counts: torch.Tensor) -> torch.Tensor:
    """Velocity from encoder counts [FR, FL, RR, RL]."""
    distance_right = (counts[..., 0] + counts[..., 2]) / 2 * DIST_PER_TICK
    distance_left = (counts[..., 1] + counts[..., 3]) / 2 * DIST_PER_TICK
    return (distance_right + distance_left) / 2 * FREQ


def dist_from_encoder(counts: torch.Tensor) -> torch.Tensor:
    """Per-step distance from encoder counts (averages FR and FL, exactly
    like the reference)."""
    return (counts[..., 0] * DIST_PER_TICK + counts[..., 1] * DIST_PER_TICK) / 2


def _sinc_half(dtheta: torch.Tensor) -> torch.Tensor:
    """sin(dtheta/2) / (dtheta/2), 1 at dtheta == 0 (series limit)."""
    h = dtheta / 2.0
    small = torch.abs(h) < 1e-8
    safe_h = torch.where(small, torch.ones_like(h), h)
    return torch.where(small, 1.0 - h * h / 6.0, torch.sin(safe_h) / safe_h)


def diff_drive_motion_model(pose_t: torch.Tensor, v_t: torch.Tensor,
                            w_t: torch.Tensor, dt: float) -> torch.Tensor:
    """One step of the sinc-corrected diff-drive model, batched over leading
    dimensions (reference modules/localization.py:15-36). w_t is the gyro
    3-vector; the yaw rate is its last component."""
    dtheta = w_t[..., -1] * dt
    x, y, theta = pose_t[..., 0], pose_t[..., 1], pose_t[..., 2]
    k = v_t * dt * _sinc_half(dtheta)
    x = x + k * torch.cos(theta + dtheta / 2.0)
    y = y + k * torch.sin(theta + dtheta / 2.0)
    return torch.stack([x, y, theta + dtheta], dim=-1)


def poses_from_odometry(
    v_ts: torch.Tensor,
    w_ts: torch.Tensor,
    x_0: torch.Tensor | None = None,
    dt: float = 1.0 / 40.0,
    return_relative_poses: bool = False,
):
    """Propagate all N poses: step i uses encoder row i and gyro row i.

    v_ts (N, 4) encoder counts, w_ts (N, 3) gyro. Returns (N, 3) poses and
    optionally the (N-1, 3, 3) relative SE(2) transforms of consecutive
    poses. Floating dtype follows v_ts (at least float32).
    """
    dtype = torch.promote_types(v_ts.dtype, torch.float32)
    if x_0 is None:
        x_0 = torch.zeros(3, dtype=dtype, device=v_ts.device)
    x_0 = x_0.to(dtype)

    v = v_from_encoder(v_ts)[1:]
    dth = w_ts[1:, -1].to(dtype) * dt
    th_cum = torch.cumsum(dth, dim=0)
    th_prev = x_0[2] + torch.cat([th_cum.new_zeros(1), th_cum[:-1]])
    mid = th_prev + dth / 2.0
    k = v.to(dtype) * dt * _sinc_half(dth)
    xs = x_0[0] + torch.cumsum(k * torch.cos(mid), dim=0)
    ys = x_0[1] + torch.cumsum(k * torch.sin(mid), dim=0)
    rest = torch.stack([xs, ys, x_0[2] + th_cum], dim=-1)
    poses = torch.cat([x_0[None], rest], dim=0)
    if return_relative_poses:
        return poses, se2.get_relative_pose(poses[:-1], poses[1:])
    return poses


def max_step_gates(v_ts: torch.Tensor, w_ts: torch.Tensor,
                   dt: float = 1.0 / 40.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-closure gates: max per-step encoder distance and max per-step
    yaw in degrees over the whole log."""
    max_distance = torch.max(dist_from_encoder(v_ts))
    max_yaw_deg = torch.rad2deg(torch.max(torch.abs(w_ts), dim=0).values[2] * dt)
    return max_distance, max_yaw_deg
