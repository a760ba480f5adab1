"""Masked, batched planar Kabsch rigid alignment.

Counterpart of the 2-D path of lidar_slam_tpu/ops/kabsch.py. The whole SLAM
pipeline aligns z = 0 clouds, whose in-plane optimum is closed-form:
theta* = atan2(S01 - S10, S00 + S11) over the weighted cross-covariance S,
the same result as an SVD with the det guard, with no iterative work.
"""

from __future__ import annotations

import torch


def masked_centroid(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted centroid over the points axis. pts (..., N, D), w (..., N)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    return torch.sum(pts * w[..., None], dim=-2) / wsum


def kabsch_planar(
    src: torch.Tensor,
    tgt: torch.Tensor,
    w: torch.Tensor | None = None,
) -> torch.Tensor:
    """Closed-form planar Kabsch: (..., N, 2) clouds -> (..., 4, 4) SE(3)
    transforms rotating about z only, minimizing
    sum w_i ||R src_i + t - tgt_i||^2. w (..., N) weights (bool masks work).
    """
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = w.to(src.dtype)

    cs = masked_centroid(src, w)
    ct = masked_centroid(tgt, w)
    X = (src - cs[..., None, :]) * w[..., None]
    Y = tgt - ct[..., None, :]
    S = torch.einsum("...nd,...ne->...de", X, Y)  # (..., 2, 2)

    theta = torch.atan2(S[..., 0, 1] - S[..., 1, 0], S[..., 0, 0] + S[..., 1, 1])
    c, s = torch.cos(theta), torch.sin(theta)
    tx = ct[..., 0] - (c * cs[..., 0] - s * cs[..., 1])
    ty = ct[..., 1] - (s * cs[..., 0] + c * cs[..., 1])

    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    rows = [
        torch.stack([c, -s, zero, tx], dim=-1),
        torch.stack([s, c, zero, ty], dim=-1),
        torch.stack([zero, zero, one, zero], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)
