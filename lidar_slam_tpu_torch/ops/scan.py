"""Lidar scan preprocessing: polar -> Cartesian with validity masks.

Counterpart of lidar_slam_tpu/ops/scan.py, with the same fixed layout:
every scan stays a (n_rays, 2) tensor plus a boolean validity mask, so the
pipeline runs over dense (N, n_rays, ...) batches and range filtering is a
mask update, never a shape change.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import LidarConfig


def scan_angles(cfg: LidarConfig, n_rays: int | None = None,
                dtype: torch.dtype = torch.float32,
                device="cpu") -> torch.Tensor:
    """Ray angles: linspace(angle_min, angle_max, n_rays) (the ray count
    comes from the data when given, like the reference)."""
    n = cfg.n_rays if n_rays is None else n_rays
    return torch.linspace(cfg.angle_min, cfg.angle_max, n, dtype=dtype,
                          device=device)


def scans_to_points(
    ranges: torch.Tensor,
    range_min: float,
    range_max: float,
    cfg: LidarConfig = LidarConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, n_rays) ranges -> robot-frame points (N, n_rays, 2) + bool mask.

    Valid rays have range_min <= r <= range_max; points are polar ->
    Cartesian in the lidar frame plus the lidar -> robot translation p_rl
    (R = I). Invalid rays keep the well-defined value p_rl.
    """
    angles = scan_angles(cfg, ranges.shape[-1], ranges.dtype, ranges.device)
    mask = (ranges >= range_min) & (ranges <= range_max)
    safe = torch.where(mask, ranges, torch.zeros_like(ranges))
    x = safe * torch.cos(angles)[None, :] + cfg.p_rl[0]
    y = safe * torch.sin(angles)[None, :] + cfg.p_rl[1]
    return torch.stack([x, y], dim=-1), mask
