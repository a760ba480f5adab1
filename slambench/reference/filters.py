"""The reference project's scan filters (main.py --filter_lidar, main.py:86-87),
written plainly from their semantics:

  DBSCAN noise removal, scan by scan (modules/localization.py:201-221):
      sklearn's DBSCAN(eps, min_samples) over the scan's points, keeping
      every point not labelled noise (-1). A point is a core point if at
      least min_samples points of its scan lie at a distance d <= eps from
      it, itself counted; a point is noise unless it is a core point or
      lies within eps of one. The cluster labels are never used.
  the statistical filter, over the whole log (:223-250): the ranges of
      every kept point of every scan pooled, their mean and population
      standard deviation; a point is kept only if its range is strictly
      below mean + k_std * sigma.

Departures from the reference, none of which changes which points are
kept beyond rounding:
  - the scans are a fixed (N, R) batch with validity masks, and a filter
    clears mask entries; the reference shrinks ragged per-scan arrays;
  - d <= eps is tested as d^2 <= eps^2, with d^2 summed from the squared
    coordinate differences in the points' dtype; sklearn's neighbour search
    compares float64 distances, so a pair within a few units in the last
    place of eps can fall on the other side;
  - a point's range is its distance from the robot's origin: the points
    are in the robot frame, the lidar's offset added, as the reference's
    get_lidar_data hands them to the filters;
  - scans go `chunk` at a time to bound the (chunk, R, R) working set; a
    scan's result depends on that scan alone.
"""

from __future__ import annotations

import torch

from .geometry import mm


def _coords(points: torch.Tensor) -> torch.Tensor:
    """The points as the filters read them: times the identity through
    geometry.mm, exact outside `with tf32():` and rounded to TF32 inside it
    (the control's precision, applied to the filters' coordinates as to
    every contraction's operands)."""
    eye = torch.eye(2, dtype=points.dtype, device=points.device)
    return mm(points, eye)


def dbscan_keep(points: torch.Tensor, masks: torch.Tensor, eps: float,
                min_samples: int, chunk: int = 16) -> torch.Tensor:
    """(N, R) mask of the valid points of scans (N, R, 2) that DBSCAN does
    not label noise, each scan on its own."""
    keep = torch.zeros_like(masks, dtype=torch.bool)
    eps2 = eps * eps
    for s in range(0, points.shape[0], chunk):
        p, m = _coords(points[s:s + chunk]), masks[s:s + chunk].bool()
        dx = p[..., :, None, 0] - p[..., None, :, 0]
        dy = p[..., :, None, 1] - p[..., None, :, 1]
        near = (dx * dx + dy * dy <= eps2) & m[..., :, None] & m[..., None, :]
        del dx, dy
        core = m & (near.sum(-1) >= min_samples)
        border = (near & core[..., None, :]).any(-1)
        keep[s:s + chunk] = m & (core | border)
    return keep


def statistical_keep(points: torch.Tensor, masks: torch.Tensor,
                     k_std: float) -> torch.Tensor:
    """(N, R) mask of the valid points whose range lies strictly below
    mean + k_std * sigma of the valid points' ranges pooled over all
    scans (population sigma)."""
    masks = masks.bool()
    p = _coords(points)
    r = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1])
    pooled = r[masks]
    if pooled.numel() == 0:
        return masks.clone()
    mean = pooled.mean()
    sigma = torch.sqrt(((pooled - mean) ** 2).mean())
    return masks & (r < mean + k_std * sigma)


def filter_keep(points: torch.Tensor, masks: torch.Tensor, eps: float,
                min_samples: int, k_std: float) -> torch.Tensor:
    """main.py --filter_lidar: DBSCAN's noise removal, then the statistical
    filter over what it kept."""
    return statistical_keep(points, dbscan_keep(points, masks, eps,
                                                min_samples), k_std)
