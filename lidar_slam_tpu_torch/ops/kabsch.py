"""Masked, batched Kabsch rigid alignment.

Counterpart of lidar_slam_tpu/ops/kabsch.py. The whole SLAM pipeline
aligns z = 0 clouds, whose in-plane optimum is closed-form:
theta* = atan2(S01 - S10, S00 + S11) over the weighted cross-covariance S,
the same result as an SVD with the det guard, with no iterative work
(kabsch_planar). The 3-D ICP warm-up (models/warmup.py) fits full 3-D
clouds with the SVD path (kabsch). Point-to-line ICP (PLICP) adds the scan
normals from ray-order neighbours and a point-to-line Gauss-Newton fit
(scan_normals_planar, fit_point_to_line_planar).
"""

from __future__ import annotations

import torch


def masked_centroid(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted centroid over the points axis. pts (..., N, D), w (..., N)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    return torch.sum(pts * w[..., None], dim=-2) / wsum


def kabsch(src: torch.Tensor, tgt: torch.Tensor,
           w: torch.Tensor | None = None) -> torch.Tensor:
    """Rigid transform T (..., D+1, D+1) minimizing
    sum w_i ||R src_i + t - tgt_i||^2 over (..., N, D) clouds; w (..., N)
    weights (bool masks work).

    R = V diag(1, .., det(V U^T)) U^T from the SVD U S V^T of the weighted
    cross-covariance, so det(R) = +1 (reference modules/icp.py:62-67). The
    D x D SVD is torch.linalg.svd (LAPACK on the CPU, cuSOLVER on the
    card), as the JAX package leaves it to jnp.linalg.svd: the two return
    singular vectors of other signs, and R is the same for either sign
    while the two smallest singular values differ.
    """
    D = src.shape[-1]
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = w.to(src.dtype)

    cs = masked_centroid(src, w)
    ct = masked_centroid(tgt, w)
    X = (src - cs[..., None, :]) * w[..., None]
    Y = tgt - ct[..., None, :]
    S = torch.einsum("...nd,...ne->...de", X, Y)  # (..., D, D)

    U, _, Vt = torch.linalg.svd(S)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    corr = torch.cat([torch.ones(det.shape + (D - 1,), dtype=src.dtype,
                                 device=src.device), det[..., None]], dim=-1)
    R = (V * corr[..., None, :]) @ Ut
    t = ct - torch.einsum("...de,...e->...d", R, cs)

    T = torch.zeros(src.shape[:-2] + (D + 1, D + 1), dtype=src.dtype,
                    device=src.device)
    T[..., :D, :D] = R
    T[..., :D, D] = t
    T[..., D, D] = 1.0
    return T


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


def scan_normals_planar(pts: torch.Tensor, mask: torch.Tensor,
                        max_gap: float = 0.5):
    """Per-point 2-D normals of a scan from its RAY-ORDER neighbours.

    pts (..., P, 2) in scan order, mask (..., P). The tangent at ray i is
    p_{i+1} - p_{i-1}, the normal its normalized perpendicular. A normal is
    valid only when both neighbours are valid and the chord is shorter than
    max_gap (a chord across a depth discontinuity is not a tangent); the
    first and last rays have no two-sided neighbour (the scan is not
    circular) and are invalid. Returns (normals (..., P, 2), valid)."""
    nxt = torch.roll(pts, -1, dims=-2)
    prv = torch.roll(pts, 1, dims=-2)
    mn = torch.roll(mask, -1, dims=-1)
    mp = torch.roll(mask, 1, dims=-1)
    d = nxt - prv
    d2 = torch.sum(d * d, dim=-1)
    valid = mask & mn & mp & (d2 < max_gap * max_gap) & (d2 > 1e-12)
    valid[..., 0] = False
    valid[..., -1] = False
    inv = torch.where(d2 > 1e-12, 1.0 / torch.sqrt(d2), torch.zeros_like(d2))
    n = torch.stack([-d[..., 1] * inv, d[..., 0] * inv], dim=-1)
    return n, valid


def fit_point_to_line_planar(src: torch.Tensor, tgt: torch.Tensor,
                             normals: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """One point-to-line Gauss-Newton step (PLICP, Censi 2008): the SE(2)
    transform minimizing sum_i w_i (n_i . (R src_i + t - tgt_i))^2 with the
    rotation linearized about 0 (the outer ICP loop composes the large
    rotation).

    src (..., N, 2) current source points, tgt and normals (..., N, 2) the
    matched target points and their normals, w (..., N) weights. Rows
    a_i = (n_x, n_y, n . (-p_y, p_x)), b_i = n . (q - p); the 3 x 3 normal
    equations carry a relative Tikhonov term (1e-8 x the mean diagonal,
    plus 1e-12) so rank-2 geometries (a straight corridor) stay finite.
    Returns (..., 4, 4) transforms with the exact rotation R(theta*)."""
    w = w.to(src.dtype)
    jp = torch.stack([-src[..., 1], src[..., 0]], dim=-1)
    a3 = torch.sum(normals * jp, dim=-1)
    A = torch.cat([normals, a3[..., None]], dim=-1)  # (..., N, 3)
    b = torch.sum(normals * (tgt - src), dim=-1)
    Aw = A * w[..., None]
    H = torch.einsum("...ni,...nj->...ij", Aw, A)
    g = torch.einsum("...ni,...n->...i", Aw, b)
    tr = (H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    x = torch.linalg.solve(H + (1e-8 * tr + 1e-12)[..., None, None] * eye,
                           g[..., None])[..., 0]
    c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    rows = [
        torch.stack([c, -s, zero, x[..., 0]], dim=-1),
        torch.stack([s, c, zero, x[..., 1]], dim=-1),
        torch.stack([zero, zero, one, zero], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)
