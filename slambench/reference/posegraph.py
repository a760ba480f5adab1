"""The GTSAM stage of the reference project, solved plainly: a prior on
pose 0, a between factor for each consecutive pair, and a factor for each
accepted loop closure, each with the error Log(meas^-1 T_i^-1 T_j) / sigma
(gtsam.BetweenFactorPose2 with diagonal noise), minimized by
Levenberg-Marquardt on the sparse normal equations with a direct solve
(SciPy's SuperLU).

It is run to convergence, well past the program's own stopping rule, so
its cost is the optimum against which the program's poses are judged.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse
from scipy.sparse.linalg import spsolve
from torch.func import jacrev, vmap

from . import geometry as geo


def _between(pi, pj, meas_inv, inv_sigma):
    rel = geo.mm(geo.inv(geo.T_of(pi)), geo.T_of(pj))
    return geo.log_se2(geo.mm(meas_inv, rel)) * inv_sigma


class Graph:
    """Factors of one trajectory: between[k] links pose k to k + 1; loops
    (loop_i, loop_j, loop_meas) are the accepted closures. Measurements are
    (.., 3, 3) SE(2) matrices in the program's convention (between factors
    T_k^-1 T_k+1, loops the ICP transform of scan i onto scan j)."""

    def __init__(self, between, loop_i, loop_j, loop_meas, prior_sigma,
                 between_sigma, loop_sigma):
        dt, dev = between.dtype, between.device
        self.n = between.shape[0] + 1
        self.i = torch.cat([torch.arange(self.n - 1, device=dev),
                            torch.as_tensor(loop_i, device=dev).long()])
        self.j = torch.cat([torch.arange(1, self.n, device=dev),
                            torch.as_tensor(loop_j, device=dev).long()])
        self.meas_inv = geo.inv(torch.cat([between, loop_meas.to(dt)]))
        nb, nl = self.n - 1, int(loop_meas.shape[0])
        sig = torch.cat([torch.tensor(between_sigma, dtype=dt,
                                      device=dev).expand(nb, 3),
                         torch.tensor(loop_sigma, dtype=dt,
                                      device=dev).expand(nl, 3)])
        self.inv_sigma = 1.0 / sig
        self.inv_prior = 1.0 / torch.tensor(prior_sigma, dtype=dt, device=dev)

    def residuals(self, x):
        r = _between(x[self.i], x[self.j], self.meas_inv, self.inv_sigma)
        rp = geo.log_se2(geo.T_of(x[0])) * self.inv_prior
        return rp, r

    def cost(self, x) -> float:
        rp, r = self.residuals(x)
        return float(0.5 * ((rp * rp).sum() + (r * r).sum()))


_JAC = vmap(jacrev(_between, argnums=(0, 1)))


def _normal_equations(g: Graph, x):
    """The Gauss-Newton system (J^T J as a sparse matrix, J^T r) at x, in
    x's dtype: residuals and Jacobians on x's device, the sum of the
    (3, 3) blocks on the host."""
    dt = np.float64 if x.dtype == torch.float64 else np.float32
    rp, r = g.residuals(x)
    Ji, Jj = _JAC(x[g.i], x[g.j], g.meas_inv, g.inv_sigma)
    Jp = jacrev(lambda p: geo.log_se2(geo.T_of(p)) * g.inv_prior)(x[0])
    i, j = g.i.cpu().numpy(), g.j.cpu().numpy()
    Ji, Jj, r = Ji.cpu().numpy(), Jj.cpu().numpy(), r.cpu().numpy()
    Jp, rp = Jp.cpu().numpy(), rp.cpu().numpy()
    ar = np.arange(3)
    grad = np.zeros((g.n, 3), dt)
    rows, cols, vals = [ar[:, None].repeat(3, 1).ravel()], [
        ar[None, :].repeat(3, 0).ravel()], [(Jp.T @ Jp).ravel()]
    grad[0] += Jp.T @ rp
    blk = (len(i), 3, 3)
    for a, Ja in ((i, Ji), (j, Jj)):
        np.add.at(grad, a, np.einsum("fki,fk->fi", Ja, r))
        for b, Jb in ((i, Ji), (j, Jj)):
            rows.append(np.broadcast_to(
                3 * a[:, None, None] + ar[None, :, None], blk).ravel())
            cols.append(np.broadcast_to(
                3 * b[:, None, None] + ar[None, None, :], blk).ravel())
            vals.append(np.einsum("fki,fkj->fij", Ja, Jb).ravel())
    n3 = 3 * g.n
    H = sparse.coo_matrix((np.concatenate(vals).astype(dt),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n3, n3)).tocsc()
    return H, grad.reshape(-1)


def optimize(g: Graph, x0: torch.Tensor, max_iters: int = 100,
             lam: float = 1e-4, rtol: float = 1e-12):
    """Levenberg-Marquardt from x0 (n, 3) with a sparse direct solve of
    (J^T J + lam I) dx = -J^T r, at most max_iters solves: a step that
    lowers the cost is taken (lam / 10) and ends the solve when it lowers
    it by at most rtol x max(cost, 1); one that does not is retried with
    lam x 10, up to 8 times in a row. Returns (poses, cost)."""
    x = x0.clone()
    cost = g.cost(x)
    eye = sparse.identity(3 * g.n, dtype=np.float64
                          if x.dtype == torch.float64 else np.float32,
                          format="csc")
    H = grad = None
    misses = 0
    for _ in range(max_iters):
        if H is None:
            H, grad = _normal_equations(g, x)
        dx = spsolve(H + lam * eye, -grad)
        x_new = x + torch.as_tensor(dx.reshape(-1, 3), dtype=x.dtype,
                                    device=x.device)
        c_new = g.cost(x_new)
        if not (np.isfinite(c_new) and c_new < cost):
            lam, misses = lam * 10.0, misses + 1
            if misses >= 8:
                break
            continue
        done = cost - c_new <= rtol * max(c_new, 1.0)
        x, cost, lam, misses, H = x_new, c_new, max(lam * 0.1, 1e-12), 0, None
        if done:
            break
    return x, cost
