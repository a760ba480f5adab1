"""Closed-form per-ray walk descriptors: the ray-walk kernel's contract.

Counterpart of lidar_slam_tpu/ops/raywalk.py::ray_descriptors. A straight
line enters and leaves the (convex) map rectangle at most once, so a ray's
in-bounds Bresenham cells are one contiguous slot interval [k_in, k_out];
both ends are closed-form. The Hopper kernel (csrc/raywalk.cu) evaluates
the same closed form per ray, with the map bounds and again with each
64 x 64 tile's bounds; this module keeps it in PyTorch so tests can hold
it equal to the JAX package's integers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MapConfig
from .bresenham import floordiv

_BIG = 1 << 28


def ray_descriptors(ends: torch.Tensor, mask: torch.Tensor, cfg: MapConfig,
                    K: int) -> Tuple[torch.Tensor, ...]:
    """ends (..., 4) int32 rows (sx, sy, ex, ey) of the rays' start and end
    cells (models/occupancy.ray_ends), mask (...) bool. Returns ten int32
    tensors (steep, sM, sm, sgM, sgm, dM, dm, c, k_in, k_out) in Bresenham
    (major k, minor m) space, with [k_in, k_out] clipped to the map, the
    K-slot cap and the mask (k_in > k_out means "skip this ray")."""
    sx, sy, ex, ey = ends.unbind(-1)
    dx0 = torch.abs(ex - sx)
    dy0 = torch.abs(ey - sy)
    is_steep = dy0 > dx0
    dM = torch.maximum(dx0, dy0)
    dm = torch.minimum(dx0, dy0)
    zero = torch.zeros_like(dM)
    one = torch.ones_like(dM)
    c = torch.where(dM > 0, dM - 1 - floordiv(dM, 2), zero)

    sgx = torch.where(sx <= ex, one, -one)
    sgy = torch.where(sy <= ey, one, -one)
    sgM = torch.where(is_steep, sgy, sgx)
    sgm = torch.where(is_steep, sgx, sgy)
    sM = torch.where(is_steep, sy, sx)
    sm = torch.where(is_steep, sx, sy)
    Mhi = torch.where(is_steep, cfg.height, cfg.width).to(torch.int32)
    mhi = torch.where(is_steep, cfg.width, cfg.height).to(torch.int32)

    aM = torch.where(sgM > 0, -sM, sM - (Mhi - 1))
    bM = torch.where(sgM > 0, Mhi - 1 - sM, sM)
    m_ub = torch.where(sgm > 0, mhi - 1 - sm, sm)
    m_lb = torch.where(sgm > 0, -sm, sm - (mhi - 1))
    dms = torch.clamp(dm, min=1)
    big = torch.full_like(dM, _BIG)
    k_ub_minor = torch.where(
        dm > 0, floordiv((m_ub + 1) * dM - 1 - c, dms),
        torch.where(m_ub >= 0, big, -one))
    k_lb_minor = torch.where(
        dm > 0, -floordiv(c - m_lb * dM, dms),
        torch.where(m_lb <= 0, -big, big))

    k_in = torch.maximum(torch.clamp(aM, min=0), k_lb_minor)
    k_out = torch.minimum(torch.minimum(dM, bM), k_ub_minor)
    k_out = torch.clamp(k_out, max=K - 1)
    valid = mask & (k_in <= k_out)
    k_in = torch.where(valid, k_in, one)
    k_out = torch.where(valid, k_out, zero)
    to32 = lambda a: a.to(torch.int32)  # noqa: E731
    return tuple(map(to32, (is_steep, sM, sm, sgM, sgm, dM, dm, c,
                            k_in, k_out)))
