"""The revisit stage and the robust pose graph of the revisit deployment
(main.py --mode gtsam --loop_proposer descriptor --robust_loss huber),
written plainly from the semantics the program states for them
(lidar_slam_tpu_torch/models/slam.py: descriptor_loop_candidates,
revisit_closures, suppress_verified_pairs; models/pose_graph.py:
_robust_w_rho):

  propose    per-scan histograms of the valid ranges over n_bins bins of
             [range_min, range_max], normalized to sum 1; all-pairs
             squared distances |d_i|^2 + |d_j|^2 - 2 d_i.d_j (clamped at
             0); the median of the consecutive scans' distances (the
             midpoint of the two middle order statistics); for each scan j
             the K nearest scans i with j - i >= min_gap (ascending, the
             lower i first on ties); the pairs at most rel_thresh x that
             median, nearest first (stable); above max_candidates of
             them, a greedy suppression in that order with a window of
             max(1, suppress_window // 4) steps on both endpoints, capped
             at max_candidates;
  verify     each pair's ICP of scan i onto scan j from the identity, with
             the loop closures' settings (normalized error, epsilon 0.01,
             stopping 1e-4, reference/icp.py); accepted when the
             translation is under max_dist and the error under max_err;
  suppress   the accepted pairs in ascending error (stable), each dropped
             when a pair already kept lies within `window` steps on both
             endpoints;
  measure    a kept pair's measurement is the inverted ICP output,
             T_i^-1 T_j (the fixed loops keep the uninverted one, as the
             reference's main.py:171 feeds it);
  optimize   Levenberg-Marquardt on the Huber cost of the loop factors
             (rho(e) = e^2 / 2 within delta, delta e - delta^2 / 2 beyond,
             e the whitened residual's norm), the prior and between
             factors least squares, by iteratively reweighted least
             squares: each linearization scales a loop factor's whitened
             residual and Jacobian by sqrt(w), w = min(1, delta / e), and
             solves reference/posegraph.py's sparse normal equations; a
             step is taken when it lowers the Huber cost. Run to
             convergence, well past the program's stopping rule, its cost
             is the optimum the program's poses are judged against.

Departures from the program's arithmetic: every step runs in the dtype it
is given (the judge's float64; the program bins its histograms in float32
and forms the distances in float32); the distances are one contraction
through geometry.mm, so inside geometry.tf32() they are rounded as the
card's TF32 would round them.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from scipy import sparse
from scipy.sparse.linalg import spsolve

from . import geometry as geo
from . import icp as ricp
from . import posegraph as rpg

K_NEAREST = 4  # candidates a scan: the program's default k


def descriptors(ranges: torch.Tensor, valid: torch.Tensor, range_min: float,
                range_max: float, n_bins: int) -> torch.Tensor:
    """(N, n_bins) histograms of the valid ranges, each normalized to sum 1
    (an empty scan stays zero): a range's bin is trunc((r - lo) / (hi - lo)
    x n_bins), clipped to the bins."""
    r = ranges
    lo, hi = float(range_min), float(range_max)
    idx = torch.clamp(((r - lo) / (hi - lo) * n_bins).to(torch.int64), 0,
                      n_bins - 1)
    h = torch.zeros((r.shape[0], n_bins), dtype=r.dtype, device=r.device)
    h.scatter_add_(1, idx, valid.to(r.dtype))
    return h / torch.clamp(h.sum(-1, keepdim=True), min=1.0)


def distances(desc: torch.Tensor) -> torch.Tensor:
    """(N, N) squared distances between the descriptors."""
    n2 = (desc * desc).sum(-1)
    d2 = n2[:, None] + n2[None, :] - 2.0 * geo.mm(desc, desc.T)
    return torch.clamp(d2, min=0.0)


def median_consecutive(d2: torch.Tensor) -> float:
    """The median of the consecutive scans' distances d2[t, t + 1]: the
    midpoint of the two middle order statistics."""
    s = torch.sort(torch.diagonal(d2, offset=1)).values
    m = s.shape[0] - 1
    return float((s[m // 2] + s[(m + 1) // 2]) * 0.5)


def suppress_greedy(li: np.ndarray, lj: np.ndarray, window: int,
                    cap: int) -> np.ndarray:
    """Positions kept by a greedy pass in the given order: a pair is
    dropped when a kept pair lies within `window` steps on both
    endpoints; at most `cap` kept."""
    kept: list[int] = []
    for m in range(li.size):
        if any(abs(int(lj[m]) - int(lj[s])) <= window
               and abs(int(li[m]) - int(li[s])) <= window for s in kept):
            continue
        kept.append(m)
        if len(kept) >= cap:
            break
    return np.asarray(kept, np.int64)


def propose(ranges: torch.Tensor, valid: torch.Tensor, range_min: float,
            range_max: float, pg: dict):
    """(loop_i, loop_j) int64 numpy arrays of the proposed pairs, in the
    proposer's order; pg holds the configuration's pose_graph keys."""
    desc = descriptors(ranges, valid, range_min, range_max,
                       int(pg["descriptor_bins"]))
    d2 = distances(desc)
    thresh = float(pg["descriptor_rel_thresh"]) * median_consecutive(d2)
    n = d2.shape[0]
    ar = torch.arange(n, device=d2.device)
    d2 = torch.where((ar[None, :] - ar[:, None]) >= int(pg[
        "proximity_min_gap"]), d2, torch.full_like(d2, float("inf")))
    vals, idx = torch.sort(d2.T, dim=-1, stable=True)
    vals = vals[:, :K_NEAREST].cpu().numpy()
    idx = idx[:, :K_NEAREST].cpu().numpy()
    jj, kk = np.where(vals <= thresh)
    order = np.argsort(vals[jj, kk], kind="stable")
    li, lj = idx[jj, kk][order].astype(np.int64), jj[order].astype(np.int64)
    cap = int(pg["proximity_max_candidates"])
    if li.size > cap:
        keep = suppress_greedy(li, lj, max(1, int(pg["proximity_suppress"])
                                           // 4), cap)
        li, lj = li[keep], lj[keep]
    return li, lj


def verify(pts: torch.Tensor, msk: torch.Tensor, li, lj, loops: dict,
           pg: dict):
    """(T (B, 3, 3) the ICP of scan i onto scan j, error (B,), accept (B,))
    of the pairs (li, lj) from the identity, with the loop closures'
    settings `loops`."""
    dev, dt = pts.device, pts.dtype
    i = torch.as_tensor(np.asarray(li), dtype=torch.int64, device=dev)
    j = torch.as_tensor(np.asarray(lj), dtype=torch.int64, device=dev)
    eye = torch.eye(3, dtype=dt, device=dev).expand(i.numel(), 3, 3)
    T, err, _ = ricp.icp(pts[i], pts[j], msk[i], msk[j], eye,
                         loops["epsilon"], loops["max_iters"],
                         loops["stopping_thresh"], True)
    accept = ((torch.linalg.vector_norm(T[:, :2, 2], dim=-1)
               < float(pg["descriptor_max_dist"]))
              & (err < float(pg["proximity_max_err"])))
    return T, err, accept


def suppress(li, lj, err, accept, window: int) -> np.ndarray:
    """Keep mask over the pairs: the accepted ones in ascending error
    (stable), each dropped when a kept pair lies within `window` steps on
    both endpoints."""
    li, lj = np.asarray(li), np.asarray(lj)
    err, accept = np.asarray(err), np.asarray(accept, bool)
    keep = np.zeros(li.shape[0], bool)
    pos = np.where(accept)[0]
    order = pos[np.argsort(err[pos], kind="stable")]
    keep[order[suppress_greedy(li[order], lj[order], window,
                               order.size)]] = True
    return keep


def revisits(pts, msk, ranges, valid, range_min, range_max, loops: dict,
             pg: dict) -> dict:
    """The whole revisit stage on one log: the proposed pairs, their
    verification, the kept pairs and their measurements T_i^-1 T_j, numpy
    arrays (the measurements a tensor on pts' device)."""
    li, lj = propose(ranges, valid, range_min, range_max, pg)
    if not li.size:
        empty = np.zeros(0, np.int64)
        return {"proposed_i": empty, "proposed_j": empty,
                "verify_accept": np.zeros(0, bool),
                "verify_err": np.zeros(0), "kept_i": empty, "kept_j": empty,
                "kept_meas": pts.new_zeros((0, 3, 3))}
    T, err, acc = verify(pts, msk, li, lj, loops, pg)
    err_np, acc_np = err.cpu().numpy(), acc.cpu().numpy()
    keep = suppress(li, lj, err_np, acc_np, int(pg["proximity_suppress"]))
    sel = torch.as_tensor(np.where(keep)[0], device=pts.device)
    return {"proposed_i": li, "proposed_j": lj, "verify_accept": acc_np,
            "verify_err": err_np, "kept_i": li[keep], "kept_j": lj[keep],
            "kept_meas": geo.inv(T[sel])}


def huber(e2: torch.Tensor, delta: float):
    """(w, rho) of the Huber kernel at squared whitened norms e2."""
    e = torch.sqrt(e2)
    out = e > delta
    w = torch.where(out, delta / torch.clamp(e, min=1e-300),
                    torch.ones_like(e))
    rho = torch.where(out, delta * e - 0.5 * delta * delta, 0.5 * e2)
    return w, rho


class RobustGraph:
    """A reference/posegraph.Graph whose loop factors (after the n - 1
    between factors) take the Huber kernel of width delta."""

    def __init__(self, graph: rpg.Graph, delta: float):
        self.g, self.delta, self.nb = graph, float(delta), graph.n - 1

    def cost(self, x) -> float:
        rp, r = self.g.residuals(x)
        rb, rl = r[:self.nb], r[self.nb:]
        _, rho = huber((rl * rl).sum(-1), self.delta)
        return float(0.5 * ((rp * rp).sum() + (rb * rb).sum()) + rho.sum())

    def outside(self, x) -> int:
        """Loop factors whose whitened residual lies beyond delta at x."""
        _, r = self.g.residuals(x)
        rl = r[self.nb:]
        return int(((rl * rl).sum(-1) > self.delta ** 2).sum())

    def reweighted(self, x) -> rpg.Graph:
        """The graph with each loop factor's whitening scaled by sqrt(w)
        at x: its least-squares system is the IRLS system of the Huber
        cost."""
        _, r = self.g.residuals(x)
        rl = r[self.nb:]
        w, _ = huber((rl * rl).sum(-1), self.delta)
        g = copy.copy(self.g)
        g.inv_sigma = torch.cat([self.g.inv_sigma[:self.nb],
                                 self.g.inv_sigma[self.nb:]
                                 * torch.sqrt(w)[:, None]])
        return g


def optimize(rg: RobustGraph, x0: torch.Tensor, max_iters: int = 200,
             lam: float = 1e-4, rtol: float = 1e-14):
    """Levenberg-Marquardt on rg's Huber cost from x0 (n, 3): each step
    solves the IRLS system at x, (J^T W J + lam I) dx = -J^T W r, by
    reference/posegraph's sparse normal equations and SuperLU; a step that
    lowers the cost is taken (lam / 10) and ends the solve when it lowers
    it by at most rtol x max(cost, 1); one that does not is retried with
    lam x 10, up to 10 times in a row. Returns (poses, cost)."""
    x = x0.clone()
    cost = rg.cost(x)
    eye = sparse.identity(3 * rg.g.n, dtype=np.float64
                          if x.dtype == torch.float64 else np.float32,
                          format="csc")
    H = grad = None
    misses = 0
    for _ in range(max_iters):
        if H is None:
            H, grad = rpg._normal_equations(rg.reweighted(x), x)
        dx = spsolve(H + lam * eye, -grad)
        x_new = x + torch.as_tensor(dx.reshape(-1, 3), dtype=x.dtype,
                                    device=x.device)
        c_new = rg.cost(x_new)
        if not (np.isfinite(c_new) and c_new < cost):
            lam, misses = lam * 10.0, misses + 1
            if misses >= 10:
                break
            continue
        done = cost - c_new <= rtol * max(c_new, 1.0)
        x, cost, lam, misses, H = x_new, c_new, max(lam * 0.1, 1e-12), 0, None
        if done:
            break
    return x, cost
