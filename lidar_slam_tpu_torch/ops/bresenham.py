"""Exact Bresenham ray traversal as a fixed-length, mask-based tensor op.

Counterpart of lidar_slam_tpu/ops/bresenham.py. Every ray produces a
FIXED (K,) slot array plus a validity mask, in closed form: slot k
advances the major axis by k, and the minor coordinate is the wrap count
of the reference's error accumulator,

    minor_k = floor((k*dy + dx - 1 - floor(dx/2)) / dx),

so the whole trace is elementwise integer arithmetic over (ray, slot), and
the visited cell set equals the reference's exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch


def floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """Integer floor division (JAX's and Python's '//' semantics)."""
    return torch.div(a, b, rounding_mode="floor")


def bresenham_fixed(sx, sy, ex, ey, K: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trace (sx, sy) -> (ex, ey) into K slots.

    int32 tensors with a common batch shape B; returns (xs, ys, mask), each
    B + (K,). Slot k holds the k-th visited cell; mask marks slots within
    the true ray length max(|dx|, |dy|) + 1. Longer rays are truncated
    tail-first.
    """
    dx0 = torch.abs(ex - sx)
    dy0 = torch.abs(ey - sy)
    steep = dy0 > dx0
    dx = torch.maximum(dx0, dy0)[..., None]
    dy = torch.minimum(dx0, dy0)[..., None]
    k = torch.arange(K, dtype=torch.int32, device=dx.device)

    denom = torch.clamp(dx, min=1)
    minor = torch.clamp(floordiv(k * dy + dx - 1 - floordiv(dx, 2), denom),
                        min=0)
    one = torch.ones_like(sx)
    sgx = torch.where(sx <= ex, one, -one)[..., None]
    sgy = torch.where(sy <= ey, one, -one)[..., None]
    sxe, sye, steepe = sx[..., None], sy[..., None], steep[..., None]
    xs = torch.where(steepe, sxe + sgx * minor, sxe + sgx * k)
    ys = torch.where(steepe, sye + sgy * k, sye + sgy * minor)
    return xs.to(torch.int32), ys.to(torch.int32), k <= dx
