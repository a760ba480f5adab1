"""Wrapper of the Hopper ray-walk map-build kernel (csrc/raywalk.cu).

raywalk_build launches the kernel for CUDA tensors; for CPU tensors it runs
the kernel's plain version, the scatter path
(models/occupancy.build_logodds_scatter). There is no fallback from a CUDA
tensor to the plain version: a build or launch failure raises.
"""

from __future__ import annotations

import torch

from ..config import MapConfig
from ..models.occupancy import build_logodds_scatter
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
