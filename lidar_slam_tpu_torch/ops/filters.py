"""Scan outlier filters as pure mask updates (main.py --filter_lidar).

Counterpart of lidar_slam_tpu/ops/filters.py, with the reference's
semantics (main.py:86-87, modules/localization.py:201-250): the reference
runs sklearn's DBSCAN per scan, then drops points whose range is not
strictly below mean + k * sigma over all scans pooled (population std).
Here, as in the JAX package, both filters only update the validity masks
of the fixed (N, P) scan batch.

The pipeline uses only DBSCAN's outlier set: a point is kept iff it is a
core point (at least min_samples neighbours within eps, itself included)
or within eps of one. That takes one masked distance matrix a scan and no
connected components. dbscan_labels gives the full labels for API
completeness, by min-label propagation to the fixpoint.

Rounding. Whether a pair lies within eps hangs on the last bit of d2 for
pairs near eps, so d2 is written out elementwise in one fixed order
(_pair_d2), which rounds alike on the CPU and on the card (no matmul, whose
cuBLAS and CPU kernels need not round alike, and no fused multiply-add).
The statistical filter's pooled sums are taken in another order by XLA,
by PyTorch on the CPU and by PyTorch on the card, so its threshold moves by
a few ULPs between them, and points whose range lies that close to it can
flip (statistical_threshold gives the threshold for that comparison).
"""

from __future__ import annotations

import torch


def _pair_d2(pts: torch.Tensor) -> torch.Tensor:
    """(..., P, P) squared pairwise distances of (..., P, 2) points:
    max(|a|^2 - 2 a.b + |b|^2, 0), each term one rounding in a fixed
    order (the JAX package's formula, its 2-term dot products written
    out)."""
    x, y = pts[..., 0], pts[..., 1]
    x2 = x * x + y * y
    cross = (x[..., :, None] * x[..., None, :]
             + y[..., :, None] * y[..., None, :])
    d2 = x2[..., :, None] - 2.0 * cross + x2[..., None, :]
    return torch.clamp_min(d2, 0.0)


def _neighbours(pts: torch.Tensor, mask: torch.Tensor, eps: float):
    """(neigh (..., P, P) bool, counts (..., P)): pairs of valid points
    within eps (d <= eps, self included; eps squared in float32)."""
    eps_t = torch.tensor(eps, dtype=pts.dtype, device=pts.device)
    neigh = ((_pair_d2(pts) <= eps_t * eps_t) & mask[..., None, :]
             & mask[..., :, None])
    return neigh, neigh.sum(-1)


def dbscan_outlier_mask(pts: torch.Tensor, mask: torch.Tensor, eps: float,
                        min_samples: int) -> torch.Tensor:
    """Non-outlier mask of a scan batch: (..., P, 2) points, (..., P)
    valid. sklearn DBSCAN's noise semantics (neighbourhood d <= eps, self
    included; reference call site modules/localization.py:216-218)."""
    mask = mask.bool()
    neigh, counts = _neighbours(pts, mask, eps)
    core = (counts >= min_samples) & mask
    border = (neigh & core[..., None, :]).any(-1)
    return mask & (core | border)


def dbscan_labels(pts: torch.Tensor, mask: torch.Tensor, eps: float,
                  min_samples: int) -> torch.Tensor:
    """Full DBSCAN cluster labels (-1 noise) by min-label propagation over
    the core-connectivity graph, swept until no label changes (a chain of
    any length gets one label; at most P sweeps). Label ids are canonical
    minima, not sklearn's visit order."""
    mask = mask.bool()
    P = pts.shape[-2]
    neigh, counts = _neighbours(pts, mask, eps)
    core = (counts >= min_samples) & mask
    idx = torch.arange(P, device=pts.device)
    unassigned = torch.full_like(idx, P)
    labels = torch.where(core, idx.expand_as(core), P)
    core_adj = neigh & core[..., None, :] & core[..., :, None]
    for _ in range(P):
        neigh_min = torch.where(core_adj, labels[..., None, :],
                                unassigned).amin(-1)
        new = torch.where(core, torch.minimum(labels, neigh_min), labels)
        if torch.equal(new, labels):
            break
        labels = new
    # borders adopt the smallest label among their core neighbours
    border_lab = torch.where(neigh & core[..., None, :], labels[..., None, :],
                             unassigned).amin(-1)
    labels = torch.where(core, labels, border_lab)
    return torch.where(mask & (labels < P), labels, -1)


def dbscan_filter_scans(points: torch.Tensor, masks: torch.Tensor,
                        eps: float = 0.1, min_samples: int = 10,
                        chunk_size: int = 16) -> torch.Tensor:
    """Per-scan DBSCAN outlier removal over the (N, P, 2) batch
    (reference: modules/localization.py:201-221, main.py:86), chunk_size
    scans at a time to bound the (chunk, P, P) working set. Each scan's
    mask depends on that scan alone, so the chunk does not change it."""
    out = torch.empty_like(masks, dtype=torch.bool)
    for s in range(0, points.shape[0], max(1, chunk_size)):
        e = s + max(1, chunk_size)
        out[s:e] = dbscan_outlier_mask(points[s:e], masks[s:e], eps,
                                       min_samples)
    return out


def statistical_threshold(points: torch.Tensor, masks: torch.Tensor,
                          k_std: float = 2.0) -> torch.Tensor:
    """(ranges (N, P), threshold 0-d): each point's range and mean +
    k_std * sigma of the valid ranges pooled over all scans (population
    std), in the points' dtype."""
    x, y = points[..., 0], points[..., 1]
    d = torch.sqrt(x * x + y * y)
    w = masks.to(points.dtype)
    n = torch.clamp_min(w.sum(), 1.0)
    mean = (d * w).sum() / n
    var = ((d - mean) ** 2 * w).sum() / n
    k = torch.tensor(k_std, dtype=points.dtype, device=points.device)
    return d, mean + k * torch.sqrt(var)


def statistical_filter_scans(points: torch.Tensor, masks: torch.Tensor,
                             k_std: float = 2.0) -> torch.Tensor:
    """Drop points with range >= mean + k_std * sigma over all scans pooled
    (reference: modules/localization.py:223-250, main.py:87; the reference
    keeps strictly-less-than, population std)."""
    d, thresh = statistical_threshold(points, masks, k_std)
    return masks.bool() & (d < thresh)
