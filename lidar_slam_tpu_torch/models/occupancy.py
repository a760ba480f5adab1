"""Log-odds occupancy grid mapping.

Counterpart of lidar_slam_tpu/models/occupancy.py, with the reference's
semantics (modules/ogm.py:5-231) and quirks:
  - world2grid is ceil((x - min)/res) - 1;
  - the ray ORIGIN is robot xy + the UNROTATED lidar offset p_rl[:2], while
    endpoints use the rotated scan points;
  - along each ray, in-bounds cells get -log4 and the LAST in-bounds cell
    +log4 (a ray leaving the map marks its last in-bounds cell occupied);
  - rays are truncated to K slots tail-first;
  - the grid is clipped to +/-logodds_clip after every scan;
  - finalize: the uint8 grid_map is 1 exactly where sigmoid(-logodds) > 0.5
    (value 1 marks FREE cells).

Two engines build the map from the rays' integer end cells (ray_ends):
the scatter path below (plain PyTorch, the plain version of the kernel) and
the Hopper ray-walk kernel (kernels/raywalk.py, csrc/raywalk.cu). Both
apply each cell's adds in ray order, so their float32 maps are equal bit
for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import LidarConfig, MapConfig
from ..ops.bresenham import bresenham_fixed


def world2grid(x: torch.Tensor, y: torch.Tensor,
               cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """World meters -> int32 cell indices: ceil((x - min)/res) - 1.

    The resolution is divided as a tensor on x's device: a Python-scalar
    divisor lets CUDA multiply by its reciprocal instead, which rounds
    differently and can move a cell boundary."""
    res = torch.tensor(cfg.resolution, dtype=x.dtype, device=x.device)
    i = torch.ceil((x - cfg.world_min_x) / res).to(torch.int32) - 1
    j = torch.ceil((y - cfg.world_min_y) / res).to(torch.int32) - 1
    return i, j


def max_ray_cells(cfg: MapConfig, range_max: float) -> int:
    """Static bound on cells per ray: ceil(range_max/res) + 8 slack."""
    return int(math.ceil(range_max / cfg.resolution)) + 8


def adaptive_ray_cells(points: torch.Tensor, masks: torch.Tensor,
                       cfg: MapConfig, range_max: float = 30.0) -> int:
    """Slot count from the longest VALID ray in the data (not range_max),
    rounded up to a multiple of 64 and capped by max_ray_cells. Exact: a
    ray's cell count is <= ceil((|p| + |p_rl|)/res) + 1."""
    m = masks.bool()
    if not bool(m.any()):
        return 64
    n2 = (points[..., 0] ** 2 + points[..., 1] ** 2)[m].max()
    max_norm = float(np.sqrt(float(n2)))
    k = int(math.ceil((max_norm + 0.28) / cfg.resolution)) + 8
    k64 = int(-(-k // 64) * 64)
    return min(k64, max_ray_cells(cfg, range_max))


def ray_ends(poses: torch.Tensor, points: torch.Tensor,
             cfg: MapConfig) -> torch.Tensor:
    """Integer start and end cells of every ray.

    poses (..., 3), points (..., R, 2) robot-frame scan points (already
    including the lidar offset). Returns (..., R, 4) int32 rows
    (sx, sy, ex, ey): the origin cell (robot xy + unrotated p_rl) and the
    endpoint cell (rotated point + robot xy)."""
    x, y, yaw = poses[..., 0:1], poses[..., 1:2], poses[..., 2:3]
    c, s = torch.cos(yaw), torch.sin(yaw)
    wx = points[..., 0] * c - points[..., 1] * s + x
    wy = points[..., 0] * s + points[..., 1] * c + y
    p_rl = LidarConfig().p_rl
    sx, sy = world2grid(x + p_rl[0], y + p_rl[1], cfg)
    ex, ey = world2grid(wx, wy, cfg)
    return torch.stack([sx.expand_as(ex), sy.expand_as(ey), ex, ey], dim=-1)


def scan_logodds_cells(ends: torch.Tensor, mask: torch.Tensor,
                       cfg: MapConfig, K: int):
    """Per-scan ray contributions in dense (R, K) slot layout.

    ends (R, 4) int32, mask (R,) bool. Returns (xs, ys, values, valid),
    each (R, K): the slot cells, +/-log4 float32 values, and which slots
    land on the map."""
    sx, sy, ex, ey = ends.unbind(-1)
    xs, ys, in_ray = bresenham_fixed(sx, sy, ex, ey, K)
    in_bounds = (xs >= 0) & (xs < cfg.width) & (ys >= 0) & (ys < cfg.height)
    valid = in_ray & in_bounds & mask[..., None]
    k = torch.arange(K, dtype=torch.int32, device=ends.device)
    last_valid = torch.max(torch.where(valid, k, -1), dim=-1,
                           keepdim=True).values
    L = torch.tensor(cfg.logodds_ratio, dtype=torch.float32,
                     device=ends.device)
    values = torch.where(valid, torch.where(k == last_valid, L, -L),
                         torch.zeros((), dtype=torch.float32,
                                     device=ends.device))
    return xs, ys, values, valid


def build_logodds_scatter(ends: torch.Tensor, masks: torch.Tensor,
                          cfg: MapConfig, K: int,
                          init: torch.Tensor | None = None) -> torch.Tensor:
    """The scatter path: the plain version of the ray-walk kernel.

    ends (N, R, 4) int32, masks (N, R) bool. For each scan in order, the
    valid slots are scattered ray-major with index_put_(accumulate=True),
    which applies every cell's adds in ray order, then the grid is clipped.
    """
    grid = (torch.zeros((cfg.width, cfg.height), dtype=torch.float32,
                        device=ends.device)
            if init is None else init.to(torch.float32).clone())
    for s in range(ends.shape[0]):
        xs, ys, values, valid = scan_logodds_cells(ends[s], masks[s], cfg, K)
        grid.index_put_((xs[valid].long(), ys[valid].long()), values[valid],
                        accumulate=True)
        grid.clamp_(-cfg.logodds_clip, cfg.logodds_clip)
    return grid


def build_logodds(
    poses: torch.Tensor,
    points: torch.Tensor,
    masks: torch.Tensor,
    cfg: MapConfig,
    K: int,
    init: torch.Tensor | None = None,
    backend: str = "auto",
) -> torch.Tensor:
    """The full log-odds grid (width, height) float32 from poses (N, 3),
    robot-frame points (N, R, 2) and masks (N, R).

    backend: "auto" runs the ray-walk kernel for CUDA tensors and the
    scatter path for CPU tensors; "cuda" requires CUDA tensors and runs the
    kernel.
    """
    from ..kernels.raywalk import raywalk_build

    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown map backend {backend!r}; "
                         "known: auto, cuda")
    if backend == "cuda" and not poses.is_cuda:
        raise RuntimeError("build_logodds(backend='cuda') needs CUDA "
                           f"tensors, got {poses.device}")
    return raywalk_build(ray_ends(poses, points, cfg), masks, cfg, K, init)


def finalize_grid(logodds: torch.Tensor) -> torch.Tensor:
    """Threshold log-odds into the uint8 grid_map (1 marks FREE cells)."""
    pmf = 1.0 / (1.0 + torch.exp(logodds))
    return (pmf > 0.5).to(torch.uint8)
