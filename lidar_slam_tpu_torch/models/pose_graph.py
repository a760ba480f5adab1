"""SE(2) pose-graph optimization by Levenberg-Marquardt: the GTSAM stage.

Counterpart of the banded path of lidar_slam_tpu/models/pose_graph.py: a
prior on pose 0, a between factor per consecutive scan-matched pair, and
gated fixed-interval loop closures, minimized by LM with the full SE(2) log
map as the error (the gtsam.BetweenFactorPose2 model).

The normal equations are solved exactly by the banded solver: every loop
factor couples pose i to pose i + interval, so grouping `band` consecutive
poses into one (3 band, 3 band) super-block makes J^T J + lam I block
tridiagonal, and a SPIKE block-tridiagonal solve (block Thomas within
segments plus a reduced interface system) applies directly. The factor
Jacobian blocks come from torch.func (jacfwd under vmap), one batched pass
per LM step. The LM loop is a Python loop that reads its done flag once per
iteration.

Only the banded solver, without robust kernels, is ported; a graph whose
live loop factors span more than `band` poses (or run backwards) raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..config import PoseGraphConfig
from ..utils import se2


class PoseGraph(NamedTuple):
    """Dense factor arrays for a 2-D pose graph.

    prior_pose (3,), prior_sigmas (3,), between_meas (B, 3, 3) SE(2)
    measurements of factors i -> i+1, between_sigmas (3,), loop_i/loop_j (L,)
    loop endpoints, loop_meas (L, 3, 3), loop_mask (L,) gate (rejected
    closures get zero weight), loop_sigmas (3,).
    """

    prior_pose: torch.Tensor
    prior_sigmas: torch.Tensor
    between_meas: torch.Tensor
    between_sigmas: torch.Tensor
    loop_i: torch.Tensor
    loop_j: torch.Tensor
    loop_meas: torch.Tensor
    loop_mask: torch.Tensor
    loop_sigmas: torch.Tensor


def make_graph(
    relative_poses: torch.Tensor,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    prior_pose: torch.Tensor | None = None,
    loop_i: torch.Tensor | None = None,
    loop_j: torch.Tensor | None = None,
    loop_meas: torch.Tensor | None = None,
    loop_mask: torch.Tensor | None = None,
) -> PoseGraph:
    """Assemble a PoseGraph from relative poses and optional loops."""
    dtype, dev = relative_poses.dtype, relative_poses.device
    if prior_pose is None:
        prior_pose = torch.zeros(3, dtype=dtype, device=dev)
    if loop_i is None:
        loop_i = torch.zeros(0, dtype=torch.int64, device=dev)
        loop_j = torch.zeros(0, dtype=torch.int64, device=dev)
        loop_meas = torch.zeros((0, 3, 3), dtype=dtype, device=dev)
        loop_mask = torch.zeros(0, dtype=torch.bool, device=dev)
    sig = lambda s: torch.tensor(s, dtype=dtype, device=dev)  # noqa: E731
    return PoseGraph(
        prior_pose=prior_pose,
        prior_sigmas=sig(cfg.prior_sigmas),
        between_meas=relative_poses,
        between_sigmas=sig(cfg.between_sigmas),
        loop_i=loop_i.long(),
        loop_j=loop_j.long(),
        loop_meas=loop_meas,
        loop_mask=loop_mask.bool(),
        loop_sigmas=sig(cfg.loop_sigmas),
    )


def _factor_residual(pose_i, pose_j, meas, inv_sigmas):
    """Whitened between-factor residual Log(meas^-1 T_i^-1 T_j) / sigma."""
    rel = se2.inverse_T(se2.T_from_pose(pose_i)) @ se2.T_from_pose(pose_j)
    return se2.log_se2(se2.inverse_T(meas) @ rel) * inv_sigmas


def _factor_r_and_J_one(pi, pj, m, s):
    r = _factor_residual(pi, pj, m, s)
    Ji, Jj = jacfwd(_factor_residual, argnums=(0, 1))(pi, pj, m, s)
    return r, Ji, Jj


# batched residual + (3, 3) Jacobian blocks wrt pose_i and pose_j
_factor_r_and_J_batch = vmap(_factor_r_and_J_one, in_dims=(0, 0, 0, None))


def _factor_r_and_J(pi, pj, meas, inv_sigmas):
    if pi.shape[0] == 0:
        z = pi.new_zeros((0, 3, 3))
        return pi.new_zeros((0, 3)), z, z
    return _factor_r_and_J_batch(pi, pj, meas, inv_sigmas)


def residuals(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """Whitened residual vector of the whole graph (gated-out loop factors
    contribute exactly zero)."""
    n = poses.shape[0]
    r_prior = se2.log_se2(se2.inverse_T(se2.T_from_pose(g.prior_pose))
                          @ se2.T_from_pose(poses[0])) / g.prior_sigmas
    r_btw = _factor_residual(poses[:n - 1], poses[1:], g.between_meas,
                             1.0 / g.between_sigmas)
    r_loop = _factor_residual(poses[g.loop_i], poses[g.loop_j], g.loop_meas,
                              1.0 / g.loop_sigmas)
    r_loop = r_loop * g.loop_mask.to(poses.dtype)[:, None]
    return torch.cat([r_prior.reshape(-1), r_btw.reshape(-1),
                      r_loop.reshape(-1)])


def graph_cost(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    r = residuals(poses, g)
    return 0.5 * torch.dot(r, r)


class LMResult(NamedTuple):
    poses: torch.Tensor
    cost: torch.Tensor
    iterations: int
    final_lambda: torch.Tensor


def _inv3x3b(A):
    """Batched closed-form (adjugate) 3x3 inverse; A (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g_, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = -(d * i - f * g_)
    C02 = d * h - e * g_
    C10 = -(b * i - c * h)
    C11 = a * i - c * g_
    C12 = -(a * h - b * g_)
    C20 = b * f - c * e
    C21 = -(a * f - c * d)
    C22 = a * e - b * d
    det = a * C00 + b * C01 + c * C02
    adjT = torch.stack([
        torch.stack([C00, C10, C20], -1),
        torch.stack([C01, C11, C21], -1),
        torch.stack([C02, C12, C22], -1),
    ], -2)
    return adjT / det[..., None, None]


def _binv(A):
    """Batched block inverse: adjugate for 3x3 blocks, LU beyond."""
    if A.shape[-1] == 3:
        return _inv3x3b(A)
    return torch.linalg.inv(A)


def _thomas(A, O, R):
    """Block-tridiagonal solve T X = R by block LDL^T (Thomas).

    A (..., n, b, b) diagonal blocks, O (..., n-1, b, b) sub-diagonal
    (O_i = T[i+1, i]), R (..., n, b, m); the chain axis is -3 and any
    leading axes are batched.
    """
    n = A.shape[-3]
    T_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    Dinv = [_binv(A[..., 0, :, :])]
    z = [R[..., 0, :, :]]
    L = []
    for i in range(1, n):
        O_p = O[..., i - 1, :, :]
        L_i = O_p @ Dinv[-1]
        Dinv.append(_binv(A[..., i, :, :] - L_i @ T_(O_p)))
        z.append(R[..., i, :, :] - L_i @ z[-1])
        L.append(L_i)
    w = torch.stack(Dinv, dim=-3) @ torch.stack(z, dim=-3)
    x = [w[..., n - 1, :, :]]
    for i in range(n - 2, -1, -1):
        x.append(w[..., i, :, :] - T_(L[i]) @ x[-1])
    return torch.stack(x[::-1], dim=-3)


def block_tridiag_solve(A, O, R, q: int = 64):
    """SPD block-tridiagonal solve T X = R, exact.

    A (n, b, b), O (n-1, b, b) with O_i = T[i+1, i], R (n, b, m). For
    n > 2q a two-level SPIKE decomposition: the chain splits into segments
    of q blocks whose q-1 interior blocks are eliminated by one Thomas solve
    batched across segments, leaving a reduced block-tridiagonal system on
    the segment-end interface blocks. Sequential depth ~2(q + n/q) instead
    of 2n, with the same arithmetic as the dense factorization.
    """
    n, b, m = A.shape[0], A.shape[-1], R.shape[-1]
    if n <= 2 * q:
        return _thomas(A, O, R)
    dtype, dev = A.dtype, A.device
    B = -(-n // q)
    n_pad = B * q
    eyeb = torch.eye(b, dtype=dtype, device=dev)
    if n_pad != n:
        A = torch.cat([A, eyeb.expand(n_pad - n, b, b)])
        O = torch.cat([O, A.new_zeros((n_pad - n, b, b))])
        R = torch.cat([R, R.new_zeros((n_pad - n, b, m))])
    T_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    # O_r[s, j] couples pose s*q+j with s*q+j+1 (one trailing zero pad)
    O_r = torch.cat([O, O.new_zeros((1, b, b))]).reshape(B, q, b, b)
    A_r = A.reshape(B, q, b, b)
    R_r = R.reshape(B, q, b, m)

    A_int = A_r[:, :q - 1]
    O_int = O_r[:, :q - 2]
    Lc = torch.cat([O.new_zeros((1, b, b)), O_r[:-1, q - 1]])
    Rc = O_r[:, q - 2]
    Ic = O_r[:, q - 1]

    Ef = A.new_zeros((B, q - 1, b, b))
    Ef[:, 0] = eyeb
    El = A.new_zeros((B, q - 1, b, b))
    El[:, q - 2] = eyeb
    Y = _thomas(A_int, O_int, torch.cat([R_r[:, :q - 1], Ef, El], dim=-1))
    YR, Yf, Yl = Y[..., :m], Y[..., m:m + b], Y[..., m + b:]

    zbb = A.new_zeros((1, b, b))
    Yf_next0 = torch.cat([Yf[1:, 0], zbb])
    YR_next0 = torch.cat([YR[1:, 0], R.new_zeros((1, b, m))])
    Yf_next_last = torch.cat([Yf[1:, q - 2], zbb])
    Rc_next = torch.cat([Rc[1:], zbb])

    A_hat = (A_r[:, q - 1] - Rc @ (Yl[:, q - 2] @ T_(Rc))
             - T_(Ic) @ (Yf_next0 @ Ic))
    O_hat = -(Rc_next[:-1] @ (Yf_next_last[:-1] @ Ic[:-1]))
    R_hat = R_r[:, q - 1] - Rc @ YR[:, q - 2] - T_(Ic) @ YR_next0
    x_hat = _thomas(A_hat, O_hat, R_hat)

    x_left = torch.cat([R.new_zeros((1, b, m)), x_hat[:-1]])
    x_int = (YR - Yf @ (Lc @ x_left)[:, None]
             - Yl @ (T_(Rc) @ x_hat)[:, None])
    X = torch.cat([x_int, x_hat[:, None]], dim=1).reshape(n_pad, b, m)
    return X[:n]


def _banded_scatter(n: int, band: int, D, off_r, off_c, off_M):
    """Scatter per-pose (3, 3) diagonal blocks D (n, 3, 3) and
    off-diagonal pose-pair blocks off_M[f] = H[off_r[f], off_c[f]]
    (off_r >= off_c, off_r - off_c <= band) into super-block tridiagonal
    storage: (A_sup (n_sup, 3 band, 3 band), O_sup (max(n_sup-1, 1), ...)).
    """
    G, dev = band, D.device
    n_sup = -(-n // G)
    bs = 3 * G
    ii = torch.arange(3, device=dev)[:, None]
    jj = torch.arange(3, device=dev)[None, :]
    ar = torch.arange(n, device=dev)
    s_all, o_all = ar // G, ar % G
    A_sup = D.new_zeros((n_sup, bs, bs))
    A_sup.index_put_((s_all[:, None, None], (3 * o_all)[:, None, None] + ii,
                      (3 * o_all)[:, None, None] + jj), D, accumulate=True)

    s_r, o_r = off_r // G, off_r % G
    s_c, o_c = off_c // G, off_c % G
    same = s_r == s_c
    adj = s_r == s_c + 1
    zero = torch.zeros_like(s_r)
    r3 = (3 * o_r)[:, None, None]
    c3 = (3 * o_c)[:, None, None]
    s_same = torch.where(same, s_r, zero)[:, None, None]
    M_same = torch.where(same[:, None, None], off_M, 0.0)
    A_sup.index_put_((s_same, r3 + ii, c3 + jj), M_same, accumulate=True)
    A_sup.index_put_((s_same, c3 + ii, r3 + jj), M_same.transpose(-1, -2),
                     accumulate=True)
    O_sup = D.new_zeros((max(n_sup - 1, 1), bs, bs))
    O_sup.index_put_((torch.where(adj, s_c, zero)[:, None, None], r3 + ii,
                      c3 + jj), torch.where(adj[:, None, None], off_M, 0.0),
                     accumulate=True)
    return A_sup, O_sup


def _banded_rhs(g, n: int, band: int):
    """-g scattered into (n_sup, 3 band, 1) super-block RHS storage."""
    G, dev = band, g.device
    n_sup = -(-n // G)
    ar = torch.arange(n, device=dev)
    R = g.new_zeros((n_sup, 3 * G, 1))
    R[(ar // G)[:, None], (3 * (ar % G))[:, None]
      + torch.arange(3, device=dev), 0] = -g
    return R


def check_banded(graph: PoseGraph, band: int) -> None:
    """The banded solve is exact only when every live loop factor spans
    0 <= loop_j - loop_i <= band; raise otherwise."""
    if graph.loop_i.shape[0] == 0:
        return
    span = (graph.loop_j - graph.loop_i)[graph.loop_mask]
    if span.numel() and (int(span.max()) > band or int(span.min()) < 0):
        raise ValueError(
            f"loop factors span [{int(span.min())}, {int(span.max())}] "
            f"poses, outside the banded solver's [0, {band}]; the direct "
            "solver for arbitrary loop topology is not yet ported")


def optimize(
    poses0: torch.Tensor,
    graph: PoseGraph,
    max_iters: int = 50,
    lambda_init: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    cost_rtol: float = 1e-9,
    band: int = 10,
) -> LMResult:
    """Levenberg-Marquardt with the exact banded solve.

    Stopping rule (gtsam checkConvergence analog): an ACCEPTED step whose
    cost decrease is at most cost_rtol * max(cost, 1) ends the optimization
    at once; rejected steps retry with lambda * lambda_up, and three
    non-improving steps in a row or lambda > 1e10 also stop it.
    """
    check_banded(graph, band)
    n = poses0.shape[0]
    dtype, dev = poses0.dtype, poses0.device
    idx_i = torch.arange(n - 1, device=dev)
    idx_j = idx_i + 1
    inv_btw = 1.0 / graph.between_sigmas
    inv_loop = 1.0 / graph.loop_sigmas
    inv_prior = 1.0 / graph.prior_sigmas
    T_prior_inv = se2.inverse_T(se2.T_from_pose(graph.prior_pose))
    lw = graph.loop_mask.to(dtype)[:, None]

    def prior_residual(p):
        return se2.log_se2(T_prior_inv @ se2.T_from_pose(p)) * inv_prior

    def linearize(x):
        rp = prior_residual(x[0])
        Jp = jacfwd(prior_residual)(x[0])
        rb, Jbi, Jbj = _factor_r_and_J(x[idx_i], x[idx_j],
                                       graph.between_meas, inv_btw)
        rl, Jli, Jlj = _factor_r_and_J(x[graph.loop_i], x[graph.loop_j],
                                       graph.loop_meas, inv_loop)
        rl = rl * lw
        Jli = Jli * lw[..., None]
        Jlj = Jlj * lw[..., None]
        jtr = lambda J, r: torch.einsum("bij,bi->bj", J, r)  # noqa: E731
        g = x.new_zeros((n, 3))
        g[0] += Jp.T @ rp
        g.index_add_(0, idx_i, jtr(Jbi, rb))
        g.index_add_(0, idx_j, jtr(Jbj, rb))
        g.index_add_(0, graph.loop_i, jtr(Jli, rl))
        g.index_add_(0, graph.loop_j, jtr(Jlj, rl))
        return (Jp, Jbi, Jbj, Jli, Jlj), g

    def cost_at(x):
        rp = prior_residual(x[0])
        rb = _factor_residual(x[idx_i], x[idx_j], graph.between_meas, inv_btw)
        rl = _factor_residual(x[graph.loop_i], x[graph.loop_j],
                              graph.loop_meas, inv_loop) * lw
        return 0.5 * (torch.dot(rp, rp) + torch.sum(rb * rb)
                      + torch.sum(rl * rl))

    def banded_solve(J, lam, g):
        Jp, Jbi, Jbj, Jli, Jlj = J
        G = band
        n_sup = -(-n // G)
        n_padded = n_sup * G
        jtj = lambda Ja, Jb: torch.einsum("bij,bik->bjk", Ja, Jb)  # noqa: E731
        D = lam * torch.eye(3, dtype=dtype, device=dev).expand(n, 3, 3).clone()
        D[0] += Jp.T @ Jp
        D.index_add_(0, idx_i, jtj(Jbi, Jbi))
        D.index_add_(0, idx_j, jtj(Jbj, Jbj))
        D.index_add_(0, graph.loop_i, jtj(Jli, Jli))
        D.index_add_(0, graph.loop_j, jtj(Jlj, Jlj))
        off_r = torch.cat([idx_j, graph.loop_j])
        off_c = torch.cat([idx_i, graph.loop_i])
        off_M = torch.cat([jtj(Jbj, Jbi), jtj(Jlj, Jli)])
        A_sup, O_sup = _banded_scatter(n, G, D, off_r, off_c, off_M)
        if n_padded != n:
            # padded tail poses: identity diagonal, zero coupling, zero rhs
            pad = torch.arange(n, n_padded, device=dev)
            A_sup.index_put_(
                ((pad // G)[:, None, None],
                 (3 * (pad % G))[:, None, None]
                 + torch.arange(3, device=dev)[:, None],
                 (3 * (pad % G))[:, None, None]
                 + torch.arange(3, device=dev)[None, :]),
                torch.eye(3, dtype=dtype, device=dev).expand(
                    n_padded - n, 3, 3),
                accumulate=True)
        X = block_tridiag_solve(A_sup, O_sup[:n_sup - 1],
                                _banded_rhs(g, n, G), q=32)
        return X.reshape(n_padded, 3)[:n]

    x = poses0
    lam = torch.tensor(lambda_init, dtype=dtype, device=dev)
    cost = cost_at(x)
    stalls = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < max_iters:
        J, g = linearize(x)
        x_new = x + banded_solve(J, lam, g)
        cost_new = cost_at(x_new)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        improved = (cost - cost_new) > cost_rtol * torch.clamp(cost, min=1.0)
        lam = torch.where(accept, lam * lambda_down, lam * lambda_up)
        stalls = torch.where(accept & improved, torch.zeros_like(stalls),
                             stalls + 1)
        done = (accept & ~improved) | (stalls >= 3) | (lam > 1e10)
        cost = torch.where(accept, cost_new, cost)
        it += 1
        if bool(done):
            break
    return LMResult(poses=x, cost=cost, iterations=it, final_lambda=lam)


def optimize_with_config(poses0: torch.Tensor, graph: PoseGraph,
                         cfg: PoseGraphConfig) -> LMResult:
    """LM solve with the config's schedule; band = cfg.fixed_interval.
    Requires cfg.solver == "banded" and cfg.robust_loss == "none" (the
    other solvers and robust kernels are not yet ported)."""
    if cfg.solver != "banded":
        raise NotImplementedError(f"pose-graph solver {cfg.solver!r} is not "
                                  "yet ported (only 'banded')")
    if cfg.robust_loss != "none":
        raise NotImplementedError(f"robust loss {cfg.robust_loss!r} is not "
                                  "yet ported (only 'none')")
    return optimize(poses0, graph, max_iters=cfg.max_lm_iters,
                    lambda_init=cfg.lambda_init, lambda_up=cfg.lambda_up,
                    lambda_down=cfg.lambda_down, cost_rtol=cfg.cost_rtol,
                    band=cfg.fixed_interval)


def optimize_trajectory(
    poses0: torch.Tensor,
    relative_poses: torch.Tensor,
    loop_i: torch.Tensor,
    loop_j: torch.Tensor,
    loop_meas: torch.Tensor,
    loop_mask: torch.Tensor,
    cfg: PoseGraphConfig = PoseGraphConfig(solver="banded"),
) -> LMResult:
    """Graph assembly (prior at the origin) + optimize_with_config."""
    graph = make_graph(relative_poses, cfg, loop_i=loop_i, loop_j=loop_j,
                       loop_meas=loop_meas, loop_mask=loop_mask)
    return optimize_with_config(poses0, graph, cfg)
