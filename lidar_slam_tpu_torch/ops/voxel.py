"""Voxel-grid downsampling.

Counterpart of lidar_slam_tpu/ops/voxel.py (the reference's
voxel_downsample, modules/icp.py:4-27, used by the ICP warm-up
code/icp_warm_up/test_icp.py:75-82): points are binned by
floor((p - min) / voxel) and each occupied voxel is replaced by the mean of
its points.

  - voxel_downsample: host numpy, variable-size output in np.unique's
    lexicographic voxel order, exactly the JAX package's routine;
  - voxel_downsample_masked: fixed-shape tensors on any device, (max_voxels,
    D) means and a validity mask in linear-voxel-id order, by a stable sort
    and segment sums (index_add_).
"""

from __future__ import annotations

import numpy as np
import torch

# prime above any realistic voxel count along an axis: the linear voxel id
# is ((v0 * SPAN) + v1) * SPAN + v2 (JAX ops/voxel.py)
SPAN = 2_097_143


def voxel_downsample(point_cloud: np.ndarray, voxel_size: float) -> np.ndarray:
    """Host-side exact equivalent of the reference routine."""
    pc = np.asarray(point_cloud)
    vox = np.floor((pc - pc.min(axis=0)) / voxel_size).astype(np.int64)
    uniq, inverse = np.unique(vox, axis=0, return_inverse=True)
    out = np.zeros((len(uniq), pc.shape[1]), dtype=pc.dtype)
    counts = np.bincount(inverse, minlength=len(uniq)).astype(pc.dtype)
    for d in range(pc.shape[1]):
        out[:, d] = np.bincount(inverse, weights=pc[:, d], minlength=len(uniq))
    return out / counts[:, None]


def voxel_downsample_masked(points: torch.Tensor, mask: torch.Tensor,
                            voxel_size: float, max_voxels: int):
    """Fixed-shape voxel means of the masked points.

    points (N, D), mask (N,) bool -> (means (max_voxels, D), valid
    (max_voxels,) bool), sorted by linear voxel id. Voxels past max_voxels
    are dropped (choose max_voxels at or above the expected occupancy); the
    masked-out points fall into no voxel."""
    N, D = points.shape
    inf = torch.full_like(points, float("inf"))
    mn = torch.where(mask[:, None], points, inf).amin(dim=0)
    vox = torch.floor((points - mn) / voxel_size).to(torch.int64)
    lin = vox[:, 0]
    for d in range(1, D):
        lin = lin * SPAN + vox[:, d]
    lin = torch.where(mask, lin, torch.iinfo(torch.int64).max)

    order = torch.sort(lin, stable=True).indices
    lin_s, pts_s, msk_s = lin[order], points[order], mask[order]
    first = torch.ones_like(msk_s)
    first[1:] = lin_s[1:] != lin_s[:-1]
    seg = torch.cumsum((first & msk_s).to(torch.int64), 0) - 1
    seg = torch.where(msk_s & (seg < max_voxels), seg, max_voxels)

    sums = torch.zeros((max_voxels + 1, D), dtype=points.dtype,
                       device=points.device).index_add_(0, seg, pts_s)
    cnts = torch.zeros(max_voxels + 1, dtype=points.dtype,
                       device=points.device).index_add_(
        0, seg, torch.ones_like(pts_s[:, 0]))
    valid = cnts[:max_voxels] > 0
    means = sums[:max_voxels] / torch.clamp(cnts[:max_voxels, None], min=1.0)
    return means, valid
