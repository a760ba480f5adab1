"""SE(2)/SE(3) pose algebra on tensors, batched over leading dimensions.

Counterpart of lidar_slam_tpu/utils/se2.py with the same conventions: a
"pose" is a (..., 3) tensor (x, y, theta); an SE(2) transform is
(..., 3, 3); an SE(3) transform is (..., 4, 4). Functions never modify
their inputs.
"""

from __future__ import annotations

import torch


def T_from_pose(pose: torch.Tensor) -> torch.Tensor:
    """Pose (..., 3) -> SE(2) matrix (..., 3, 3)."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows = [
        torch.stack([c, -s, x], dim=-1),
        torch.stack([s, c, y], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def pose_from_T(T: torch.Tensor) -> torch.Tensor:
    """SE(2) (..., 3, 3) or SE(3) (..., 4, 4) -> pose (..., 3)."""
    if T.shape[-1] == 4:
        T = TSE2_from_TSE3(T)
    th = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.stack([T[..., 0, 2], T[..., 1, 2], th], dim=-1)


def TSE2_from_TSE3(T_SE3: torch.Tensor) -> torch.Tensor:
    """SE(3) (..., 4, 4) -> SE(2) (..., 3, 3), keeping the xy block."""
    batch = T_SE3.shape[:-2]
    T = torch.eye(3, dtype=T_SE3.dtype, device=T_SE3.device).expand(
        batch + (3, 3)).clone()
    T[..., :2, :2] = T_SE3[..., :2, :2]
    T[..., :2, 2] = T_SE3[..., :2, 3]
    return T


def TSE3_from_TSE2(T_SE2: torch.Tensor) -> torch.Tensor:
    """SE(2) (..., 3, 3) -> SE(3) (..., 4, 4) with zero z / identity z-rotation."""
    batch = T_SE2.shape[:-2]
    T = torch.eye(4, dtype=T_SE2.dtype, device=T_SE2.device).expand(
        batch + (4, 4)).clone()
    T[..., :2, :2] = T_SE2[..., :2, :2]
    T[..., :2, 3] = T_SE2[..., :2, 2]
    return T


def inverse_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse [R^T, -R^T t] of (..., 3, 3) or (..., 4, 4)."""
    d = T.shape[-1] - 1
    Rt = T[..., :d, :d].transpose(-1, -2)
    t = T[..., :d, d]
    tinv = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, tinv[..., None]], dim=-1)
    batch = T.shape[:-2]
    bottom = torch.cat([T.new_zeros(batch + (1, d)),
                        T.new_ones(batch + (1, 1))], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def get_relative_pose(pose_t1: torch.Tensor,
                      pose_t2: torch.Tensor) -> torch.Tensor:
    """Relative SE(2) transform T1^-1 @ T2, (..., 3, 3)."""
    return inverse_T(T_from_pose(pose_t1)) @ T_from_pose(pose_t2)


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply T to points: (..., N, 2) with (..., 3, 3), or (..., N, 3) with
    (..., 4, 4)."""
    d = points.shape[-1]
    if T.shape[-1] != d + 1:
        raise ValueError(
            f"Invalid point/transform shapes: points {tuple(points.shape)}, "
            f"T {tuple(T.shape)}")
    R = T[..., :d, :d]
    t = T[..., :d, d]
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def compose_chain(relative_Ts: torch.Tensor,
                  T0: torch.Tensor | None = None) -> torch.Tensor:
    """Prefix-compose (N, 3, 3) relative transforms into (N+1, 3, 3) global
    transforms [T0, T0@R0, T0@R0@R1, ...].

    A log-depth inclusive scan (Hillis-Steele doubling: ceil(log2 N) batched
    matmuls), the counterpart of the JAX package's lax.associative_scan.
    Products keep their left-to-right order; only the grouping differs from
    a sequential fold, so results agree to accumulation ULPs.
    """
    if T0 is None:
        T0 = torch.eye(3, dtype=relative_Ts.dtype, device=relative_Ts.device)
    chain = torch.cat([T0[None], relative_Ts], dim=0)
    d = 1
    while d < chain.shape[0]:
        chain = torch.cat([chain[:d], chain[:-d] @ chain[d:]], dim=0)
        d *= 2
    return chain


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def _ab(omega: torch.Tensor):
    """a = sin(w)/w, b = (1-cos(w))/w with series guards at w = 0.

    The constant divisors are tensors of omega's dtype: torch.func.jacfwd
    of a 0-d tensor divided by a Python float returns a float64 tangent,
    which would turn float32 Jacobians into float64 ones."""
    small = torch.abs(omega) < 1e-6
    w = torch.where(small, torch.ones_like(omega), omega)
    six, two = omega.new_tensor(6.0), omega.new_tensor(2.0)
    a = torch.where(small, 1.0 - omega * omega / six, torch.sin(w) / w)
    b = torch.where(small, omega / two, (1.0 - torch.cos(w)) / w)
    return a, b


def log_se2(T: torch.Tensor) -> torch.Tensor:
    """SE(2) logarithm: (..., 3, 3) -> (..., 3) tangent (vx, vy, omega), the
    full chart with the V-matrix coupling (GTSAM's Pose2 log map)."""
    omega = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    tx, ty = T[..., 0, 2], T[..., 1, 2]
    a, b = _ab(omega)
    den = a * a + b * b
    vx = (a * tx + b * ty) / den
    vy = (-b * tx + a * ty) / den
    return torch.stack([vx, vy, omega], dim=-1)


def exp_se2(xi: torch.Tensor) -> torch.Tensor:
    """SE(2) exponential: (..., 3) tangent (vx, vy, omega) -> (..., 3, 3)."""
    vx, vy, omega = xi[..., 0], xi[..., 1], xi[..., 2]
    a, b = _ab(omega)
    tx = a * vx - b * vy
    ty = b * vx + a * vy
    return T_from_pose(torch.stack([tx, ty, omega], dim=-1))
