"""Point-to-point ICP of 2-D scans, with the reference project's stopping
rules, over many pairs at once.

One iteration of a pair, from its current transform T:
  1. move the source points by T;
  2. match each to its nearest valid target point (squared distances as
     |s|^2 + |t|^2 - 2 s.t, a matmul; the lowest index wins a tie);
  3. measure the error at T: the sum over valid source points of the
     squared distance to the match, or, normalized, that sum divided by the
     valid count and by the squared diagonal of the box around the moved
     valid sources and their matches;
  4. fit the rigid motion of the moved valid sources onto their matches
     (Kabsch by the SVD of the 2 x 2 cross-covariance, det guarded) and
     compose it onto T.
A pair stops after the iteration in which its error fell below epsilon,
or its error changed by less than stopping_thresh from the iteration
before, or it had already made max_iters iterations; it runs at least one.
The returned transform is the one composed in the last iteration.

Live pairs are processed `chunk` at a time; a pair's result does not
depend on which pairs share its chunk.
"""

from __future__ import annotations

import torch

from .geometry import mm

INF = float("inf")


def _nearest(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor):
    d = ((src * src).sum(-1)[..., :, None] + (tgt * tgt).sum(-1)[..., None, :]
         - 2.0 * mm(src, tgt.transpose(-1, -2)))
    d = torch.where(tgt_mask[..., None, :], d, torch.full_like(d, INF))
    return torch.argmin(d, dim=-1)


def _kabsch2(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor):
    """(B, 3, 3) rigid motions minimizing sum w |R src + t - tgt|^2."""
    ws = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    cs = (src * w[..., None]).sum(-2) / ws
    ct = (tgt * w[..., None]).sum(-2) / ws
    H = mm(((src - cs[:, None]) * w[..., None]).transpose(-1, -2),
           tgt - ct[:, None])
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    d = torch.linalg.det(mm(V, U.transpose(-1, -2)))
    V = torch.cat([V[..., :1], V[..., 1:] * d[:, None, None]], dim=-1)
    R = mm(V, U.transpose(-1, -2))
    T = torch.zeros(src.shape[0], 3, 3, dtype=src.dtype, device=src.device)
    T[:, :2, :2] = R
    T[:, :2, 2] = ct - mm(R, cs[..., None])[..., 0]
    T[:, 2, 2] = 1.0
    return T


def _error(moved, matched, mask, normalize: bool):
    d2 = ((moved - matched) ** 2).sum(-1)
    err = torch.where(mask, d2, torch.zeros_like(d2)).sum(-1)
    if not normalize:
        return err
    m = mask[..., None]
    both = torch.cat([moved, matched], dim=-2)
    m2 = torch.cat([m, m], dim=-2)
    lo = torch.where(m2, both, torch.full_like(both, INF)).amin(-2)
    hi = torch.where(m2, both, torch.full_like(both, -INF)).amax(-2)
    diag2 = ((hi - lo) ** 2).sum(-1)
    n = torch.clamp(mask.sum(-1), min=1).to(moved.dtype)
    return err / (diag2 * n)


def icp(src, tgt, src_mask, tgt_mask, T0, epsilon: float, max_iters: int,
        stopping_thresh: float, normalize: bool = False, chunk: int = 128):
    """ICP of B pairs: src (B, P, 2) onto tgt (B, Q, 2), validity masks
    (B, P) and (B, Q), seeds T0 (B, 3, 3). Returns (T (B, 3, 3), error
    (B,), iterations (B,))."""
    B = src.shape[0]
    dev, dt = src.device, src.dtype
    T = T0.to(dt).clone()
    err = torch.full((B,), INF, dtype=dt, device=dev)
    last = torch.full((B,), INF, dtype=dt, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        live = torch.nonzero(~done).flatten()
        if live.numel() == 0:
            return T, err, k
        for c in live.split(chunk):
            Tc = T[c]
            moved = (mm(src[c], Tc[:, :2, :2].transpose(-1, -2))
                     + Tc[:, None, :2, 2])
            idx = _nearest(moved, tgt[c], tgt_mask[c])
            matched = torch.gather(tgt[c], 1, idx[..., None].expand(-1, -1, 2))
            m = src_mask[c]
            e = _error(moved, matched, m, normalize)
            fit = _kabsch2(moved, matched, m.to(dt))
            first = torch.isinf(last[c])
            stop = ((e < epsilon) | (k[c] >= max_iters)
                    | (~first & (torch.abs(last[c] - e) < stopping_thresh)))
            T[c] = mm(fit, Tc)
            err[c] = e
            last[c] = e
            k[c] += 1
            done[c] = stop
