"""Nearest-neighbour correspondences as a brute-force masked argmin.

Counterpart of lidar_slam_tpu/ops/nn.py and the plain version of the
Hopper NN kernel (kernels/nn.py, csrc/nn.cu): d(i, j) = |t_j|^2 - 2 s_i.t_j
(the |s_i|^2 term is constant per row and skipped), masked targets replaced
by 1e30, row argmin with the lowest index winning ties. Exact, like the
KDTree of the reference it replaces. It materializes the (..., N, M)
distance tensor; the kernel does not.
"""

from __future__ import annotations

import torch

BIG = 1e30


def nearest_neighbors(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Index of the nearest target for every source point.

    src (..., N, D), tgt (..., M, D), tgt_mask (..., M) bool -> (..., N)
    int32. Masked-out targets are never selected while any target is valid.
    """
    cross = torch.einsum("...nd,...md->...nm", src, tgt)
    t2 = torch.sum(tgt * tgt, dim=-1)
    d = t2[..., None, :] - 2.0 * cross
    if tgt_mask is not None:
        d = torch.where(tgt_mask[..., None, :], d, torch.full_like(d, BIG))
    return torch.argmin(d, dim=-1).to(torch.int32)


def gather_points(tgt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tgt (..., M, D) rows at idx (..., N) -> (..., N, D)."""
    ix = idx.long()[..., None].expand(idx.shape + (tgt.shape[-1],))
    return torch.gather(tgt, -2, ix)
