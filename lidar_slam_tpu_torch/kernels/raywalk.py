"""Wrappers of the Hopper ray-walk kernels (csrc/raywalk.cu).

raywalk_build (the whole map build) and raywalk_scan (one scan on a carried
grid, in place) launch their kernels for CUDA tensors; for CPU tensors they
run the kernels' plain version, the scatter path
(models/occupancy.build_logodds_scatter and scatter_scan_). There is no
fallback from a CUDA tensor to the plain version: a build or launch
failure raises.
"""

from __future__ import annotations

import torch

from ..config import MapConfig
from ..models.occupancy import build_logodds_scatter, scatter_scan_
from . import build


def raywalk_build(ends: torch.Tensor, masks: torch.Tensor, cfg: MapConfig,
                  K: int, init: torch.Tensor | None = None) -> torch.Tensor:
    """Log-odds grid (width, height) float32 from ray end cells.

    ends (N, R, 4) int32 rows (sx, sy, ex, ey), masks (N, R) bool, init an
    optional (width, height) starting grid. Scans are applied in order, rays
    in order within a scan, and the grid is clipped after every scan.
    """
    if not ends.is_cuda:
        return build_logodds_scatter(ends, masks, cfg, K, init)
    W, H = cfg.width, cfg.height
    if ends.dim() != 3 or ends.shape[-1] != 4 or ends.dtype != torch.int32:
        raise ValueError(f"ends must be (N, R, 4) int32, got "
                         f"{tuple(ends.shape)} {ends.dtype}")
    N, R = ends.shape[:2]
    if (masks.shape != (N, R) or masks.dtype != torch.bool
            or masks.device != ends.device):
        raise ValueError(f"masks must be ({N}, {R}) bool on {ends.device}, "
                         f"got {tuple(masks.shape)} {masks.dtype} "
                         f"{masks.device}")
    if not (ends.is_contiguous() and masks.is_contiguous()):
        raise ValueError("ends and masks must be contiguous")
    if K <= 0:
        raise ValueError(f"K must be positive, got {K}")
    if init is None:
        grid = torch.zeros((W, H), dtype=torch.float32, device=ends.device)
    else:
        if (init.shape != (W, H) or init.dtype != torch.float32
                or init.device != ends.device):
            raise ValueError(f"init must be ({W}, {H}) float32 on "
                             f"{ends.device}")
        grid = init.clone()
    lib = build.library()
    with torch.cuda.device(ends.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.slam_raywalk_build(
            ends.data_ptr(), masks.data_ptr(), N, R, W, H, int(K),
            float(cfg.logodds_ratio), float(cfg.logodds_clip),
            grid.data_ptr(), stream)
        raywalk_build.launches += 1
    if rc != 0:
        raise RuntimeError(f"raywalk_build kernel launch failed: CUDA error "
                           f"{rc}")
    return grid


raywalk_build.launches = 0


def raywalk_scan(ends: torch.Tensor, mask: torch.Tensor, cfg: MapConfig,
                 K: int, grid: torch.Tensor,
                 clip: float | None) -> torch.Tensor:
    """Walk one scan's rays into grid (width, height) float32 IN PLACE and
    return grid itself (no copy, no allocation).

    ends (R, 4) int32 rows (sx, sy, ex, ey), mask (R,) bool. Rays are
    applied in order; clip=None leaves the result unclipped (the per-scan
    delta when grid starts at zero), a float clips the whole grid to
    +/-clip afterwards.
    """
    if not ends.is_cuda:
        scatter_scan_(grid, ends, mask, cfg, K)
        if clip is not None:
            grid.clamp_(-clip, clip)
        return grid
    W, H = cfg.width, cfg.height
    if ends.dim() != 2 or ends.shape[-1] != 4 or ends.dtype != torch.int32:
        raise ValueError(f"ends must be (R, 4) int32, got "
                         f"{tuple(ends.shape)} {ends.dtype}")
    R = ends.shape[0]
    if (mask.shape != (R,) or mask.dtype != torch.bool
            or mask.device != ends.device):
        raise ValueError(f"mask must be ({R},) bool on {ends.device}, got "
                         f"{tuple(mask.shape)} {mask.dtype} {mask.device}")
    if (grid.shape != (W, H) or grid.dtype != torch.float32
            or grid.device != ends.device):
        raise ValueError(f"grid must be ({W}, {H}) float32 on {ends.device}, "
                         f"got {tuple(grid.shape)} {grid.dtype} "
                         f"{grid.device}")
    if not (ends.is_contiguous() and mask.is_contiguous()
            and grid.is_contiguous()):
        raise ValueError("ends, mask and grid must be contiguous")
    if K <= 0:
        raise ValueError(f"K must be positive, got {K}")
    lib = build.library()
    with torch.cuda.device(ends.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.slam_raywalk_scan(
            ends.data_ptr(), mask.data_ptr(), R, W, H, int(K),
            float(cfg.logodds_ratio), 0.0 if clip is None else float(clip),
            int(clip is not None), grid.data_ptr(), stream)
        raywalk_scan.launches += 1
    if rc != 0:
        raise RuntimeError(f"raywalk_scan kernel launch failed: CUDA error "
                           f"{rc}")
    return grid


raywalk_scan.launches = 0
