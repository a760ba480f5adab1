"""SE(2) pose-graph optimization by Levenberg-Marquardt: the GTSAM stage.

Counterpart of the banded path of lidar_slam_tpu/models/pose_graph.py: a
prior on pose 0, a between factor per consecutive scan-matched pair, and
gated fixed-interval loop closures, minimized by LM with the full SE(2) log
map as the error (the gtsam.BetweenFactorPose2 model).

The three linear solvers of the JAX package are ported. "banded": every
fixed-interval loop couples pose i to pose i + interval, so grouping `band`
consecutive poses into one (3 band, 3 band) super-block makes
J^T J + lam I block tridiagonal, and a SPIKE block-tridiagonal solve (block
Thomas within segments plus a reduced interface system) applies directly; a
graph whose live loops span more than `band` poses (or run backwards)
falls back to "direct", as the JAX package's optimize does. "direct": the
same SPIKE solve over the chain alone with a Woodbury correction for the
loop factors, exact for any loop topology (the revisit closures). "cg":
block-Jacobi preconditioned conjugate gradients. The Huber and Cauchy
robust kernels reweight the loop factors (IRLS). The factor Jacobian blocks
come from torch.func (jacfwd under vmap), one batched pass per LM step. The
LM loop is a Python loop that reads its done flag once per iteration; CG
reads its residual norm once per CG iteration.
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


def _loop_span_violation(loop_i: torch.Tensor, loop_j: torch.Tensor,
                         loop_mask: torch.Tensor, band: int):
    """The (min, max) span loop_j - loop_i of the live loops when one lies
    outside [0, band], else None: the banded assembly keeps off-diagonal
    blocks in the lower triangle, so a reversed arc is outside too. Reads
    the loop arrays on the host. The one span check behind optimize's
    fallback to "direct" and the sharded solver's refusals."""
    if loop_i.shape[0] == 0:
        return None
    span = (loop_j - loop_i)[loop_mask.bool()]
    if span.numel() == 0:
        return None
    lo, hi = int(span.min()), int(span.max())
    return (lo, hi) if hi > band or lo < 0 else None


def banded_exact(graph: PoseGraph, band: int) -> bool:
    """Whether the banded solve is exact for this graph: every live loop
    factor spans 0 <= loop_j - loop_i <= band."""
    return _loop_span_violation(graph.loop_i, graph.loop_j,
                                graph.loop_mask, band) is None


def _robust_w_rho(e2: torch.Tensor, kind: str, delta: float):
    """Per-factor IRLS weight w = rho'(e)/e and robust cost rho(e) from the
    squared whitened residual norm e2 (L,): the Huber and Cauchy
    m-estimators of gtsam.noiseModel.mEstimator. Scaling the whitened loop
    residual and Jacobian blocks by sqrt(w) at each linearization is how
    GTSAM applies a robust noise model inside LM (the rho'' term omitted).
    Both kernels are the identity as e -> 0; masked factors have e2 = 0."""
    if kind == "huber":
        e = torch.sqrt(e2)
        out = e > delta
        w = torch.where(out, delta / torch.clamp(e, min=1e-30),
                        torch.ones_like(e))
        rho = torch.where(out, delta * e - 0.5 * delta * delta, 0.5 * e2)
    elif kind == "cauchy":
        t = e2 / (delta * delta)
        w = 1.0 / (1.0 + t)
        rho = 0.5 * delta * delta * torch.log1p(t)
    else:
        raise ValueError(f"unknown robust kernel {kind!r}")
    return w, rho


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg_solve(matvec, b: torch.Tensor, x0: torch.Tensor, precond,
             tol: float, maxiter: int) -> torch.Tensor:
    """Preconditioned conjugate gradients for A x = b, step for step as
    jax.scipy.sparse.linalg.cg (jax 0.9.0 _cg_solve): stop once
    r.r <= max(tol^2 (b.b), 0) or after maxiter iterations, starting from
    r0 = b - A x0 and p0 = z0 = M r0. The loop reads r.r on the host once
    an iteration."""
    atol2 = torch.clamp(tol * tol * _vdot(b, b), min=0.0)
    r = b - matvec(x0)
    p = z = precond(r)
    gamma = _vdot(r, z)
    x, k = x0, 0
    while k < maxiter and bool(_vdot(r, r) > atol2):
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        gamma_new = _vdot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


def optimize(
    poses0: torch.Tensor,
    graph: PoseGraph,
    max_iters: int = 50,
    lambda_init: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    cg_iters: int = 250,
    cg_tol: float = 1e-8,
    cost_rtol: float = 1e-9,
    solver: str = "direct",
    band: int = 10,
    robust: str = "none",
    robust_delta: float = 1.0,
) -> LMResult:
    """Levenberg-Marquardt over the graph with the chosen linear solver.

    solver "banded": the exact super-block tridiagonal solve, exact only
    when every live loop spans at most `band` poses forward; a graph that
    breaks that falls back to "direct" (_loop_span_violation). "direct":
    the exact Newton step, SPIKE over the chain's block-tridiagonal
    Hessian plus a Woodbury correction for the loop factors, any
    topology. "cg": block-Jacobi preconditioned CG, warm-started from the
    last rejected step. robust in {"none", "huber", "cauchy"} applies
    that m-estimator (width robust_delta, whitened units) to the LOOP
    factors by IRLS.

    Stopping rule (gtsam checkConvergence analog): an ACCEPTED step whose
    cost decrease is at most cost_rtol * max(cost, 1) ends the optimization
    at once; rejected steps retry with lambda * lambda_up, and three
    non-improving steps in a row or lambda > 1e10 also stop it.
    """
    if solver not in ("banded", "direct", "cg"):
        raise ValueError(f"unknown pose-graph solver {solver!r}")
    if solver == "banded" and _loop_span_violation(
            graph.loop_i, graph.loop_j, graph.loop_mask, band) is not None:
        solver = "direct"
    n = poses0.shape[0]
    dtype, dev = poses0.dtype, poses0.device
    idx_i = torch.arange(n - 1, device=dev)
    idx_j = idx_i + 1
    n_loops = int(graph.loop_i.shape[0])
    inv_btw = 1.0 / graph.between_sigmas
    inv_loop = 1.0 / graph.loop_sigmas
    inv_prior = 1.0 / graph.prior_sigmas
    T_prior_inv = se2.inverse_T(se2.T_from_pose(graph.prior_pose))
    lw = graph.loop_mask.to(dtype)[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    jtj = lambda Ja, Jb: torch.einsum("bij,bik->bjk", Ja, Jb)  # noqa: E731
    jtr = lambda J, r: torch.einsum("bij,bi->bj", J, r)  # noqa: E731
    jv = lambda J, v: torch.einsum("bij,bj->bi", J, v)  # noqa: E731

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
        if robust != "none":
            # IRLS: sqrt(w)-scaled loop blocks, so every solver sees the
            # reweighted normal equations
            w, _ = _robust_w_rho(torch.sum(rl * rl, dim=1), robust,
                                 robust_delta)
            sw = torch.sqrt(w)[:, None]
            rl = rl * sw
            Jli = Jli * sw[..., None]
            Jlj = Jlj * sw[..., None]
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
        if robust == "none":
            loop_cost = 0.5 * torch.sum(rl * rl)
        else:
            _, rho = _robust_w_rho(torch.sum(rl * rl, dim=1), robust,
                                   robust_delta)
            loop_cost = torch.sum(rho)
        return 0.5 * (torch.dot(rp, rp) + torch.sum(rb * rb)) + loop_cost

    def diagonal_blocks(J, lam, with_loops: bool):
        """lam I plus the (3, 3) diagonal blocks of J^T J, per pose."""
        Jp, Jbi, Jbj, Jli, Jlj = J
        D = lam * eye3.expand(n, 3, 3).clone()
        D[0] += Jp.T @ Jp
        D.index_add_(0, idx_i, jtj(Jbi, Jbi))
        D.index_add_(0, idx_j, jtj(Jbj, Jbj))
        if with_loops:
            D.index_add_(0, graph.loop_i, jtj(Jli, Jli))
            D.index_add_(0, graph.loop_j, jtj(Jlj, Jlj))
        return D

    def banded_solve(J, lam, g):
        Jp, Jbi, Jbj, Jli, Jlj = J
        G = band
        n_sup = -(-n // G)
        n_padded = n_sup * G
        D = diagonal_blocks(J, lam, True)
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
                eye3.expand(n_padded - n, 3, 3), accumulate=True)
        X = block_tridiag_solve(A_sup, O_sup[:n_sup - 1],
                                _banded_rhs(g, n, G), q=32)
        return X.reshape(n_padded, 3)[:n]

    def direct_solve(J, lam, g):
        """Exact Newton step: SPIKE over the chain's block-tridiagonal
        part of J^T J + lam I with the right-hand sides [-g | U], U's
        columns the loop Jacobians transposed (1 + 3L columns, every loop
        candidate, live or not), then the Woodbury correction
        x = y_b - Y_u (I + U^T Y_u)^-1 U^T y_b."""
        Jp, Jbi, Jbj, Jli, Jlj = J
        A = diagonal_blocks(J, lam, False)
        O = jtj(Jbj, Jbi)  # O_i = H[i+1, i]
        if n_loops:
            R = g.new_zeros((n, 3, 1 + 3 * n_loops))
            R[:, :, 0] = -g
            rows = torch.arange(3, device=dev)[None, :, None]
            cols = (1 + 3 * torch.arange(n_loops, device=dev)[:, None]
                    + torch.arange(3, device=dev)[None, :])[:, None, :]
            R.index_put_((graph.loop_i[:, None, None], rows, cols),
                         Jli.transpose(1, 2), accumulate=True)
            R.index_put_((graph.loop_j[:, None, None], rows, cols),
                         Jlj.transpose(1, 2), accumulate=True)
        else:
            R = (-g)[:, :, None]
        Y = block_tridiag_solve(A, O, R)
        yb = Y[:, :, 0]
        if not n_loops:
            return yb
        UtY = (torch.einsum("lab,lbm->lam", Jli, Y[graph.loop_i])
               + torch.einsum("lab,lbm->lam", Jlj, Y[graph.loop_j]))
        UtY = UtY.reshape(3 * n_loops, -1)
        S = torch.eye(3 * n_loops, dtype=dtype, device=dev) + UtY[:, 1:]
        zc = torch.linalg.solve(S, UtY[:, 0])
        return yb - torch.einsum("nim,m->ni", Y[:, :, 1:], zc)

    def cg_step(J, lam, g, x0):
        Jp, Jbi, Jbj, Jli, Jlj = J
        Dinv = _inv3x3b(diagonal_blocks(J, lam, True))

        def matvec(v):
            # u_f = J_i v_i + J_j v_j per factor; y_i += J_i^T u_f etc.
            y = lam * v
            y[0] += Jp.T @ (Jp @ v[0])
            ub = jv(Jbi, v[idx_i]) + jv(Jbj, v[idx_j])
            y.index_add_(0, idx_i, jtr(Jbi, ub))
            y.index_add_(0, idx_j, jtr(Jbj, ub))
            ul = jv(Jli, v[graph.loop_i]) + jv(Jlj, v[graph.loop_j])
            y.index_add_(0, graph.loop_i, jtr(Jli, ul))
            y.index_add_(0, graph.loop_j, jtr(Jlj, ul))
            return y

        return cg_solve(matvec, -g, x0,
                        lambda v: torch.einsum("nij,nj->ni", Dinv, v),
                        cg_tol, cg_iters)

    x = poses0
    lam = torch.tensor(lambda_init, dtype=dtype, device=dev)
    cost = cost_at(x)
    stalls = torch.zeros((), dtype=torch.int64, device=dev)
    dx_prev = torch.zeros_like(poses0)
    it = 0
    while it < max_iters:
        J, g = linearize(x)
        if solver == "banded":
            dx = banded_solve(J, lam, g)
        elif solver == "direct":
            dx = direct_solve(J, lam, g)
        else:
            dx = cg_step(J, lam, g, dx_prev)
        x_new = x + dx
        cost_new = cost_at(x_new)
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        improved = (cost - cost_new) > cost_rtol * torch.clamp(cost, min=1.0)
        lam = torch.where(accept, lam * lambda_down, lam * lambda_up)
        stalls = torch.where(accept & improved, torch.zeros_like(stalls),
                             stalls + 1)
        done = (accept & ~improved) | (stalls >= 3) | (lam > 1e10)
        cost = torch.where(accept, cost_new, cost)
        # the CG warm start resets on an accepted step
        dx_prev = torch.where(accept, torch.zeros_like(dx), dx)
        it += 1
        if bool(done):
            break
    return LMResult(poses=x, cost=cost, iterations=it, final_lambda=lam)


def optimize_with_config(poses0: torch.Tensor, graph: PoseGraph,
                         cfg: PoseGraphConfig = PoseGraphConfig()
                         ) -> LMResult:
    """LM solve with the config's schedule, solver and robust kernel;
    band = cfg.fixed_interval."""
    return optimize(poses0, graph, max_iters=cfg.max_lm_iters,
                    lambda_init=cfg.lambda_init, lambda_up=cfg.lambda_up,
                    lambda_down=cfg.lambda_down, cg_iters=cfg.cg_iters,
                    cg_tol=cfg.cg_tol, cost_rtol=cfg.cost_rtol,
                    solver=cfg.solver, band=cfg.fixed_interval,
                    robust=cfg.robust_loss, robust_delta=cfg.robust_delta)


def optimize_trajectory(
    poses0: torch.Tensor,
    relative_poses: torch.Tensor,
    loop_i: torch.Tensor,
    loop_j: torch.Tensor,
    loop_meas: torch.Tensor,
    loop_mask: torch.Tensor,
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> LMResult:
    """Graph assembly (prior at the origin) + optimize_with_config."""
    graph = make_graph(relative_poses, cfg, loop_i=loop_i, loop_j=loop_j,
                       loop_meas=loop_meas, loop_mask=loop_mask)
    return optimize_with_config(poses0, graph, cfg)


def optimize_sharded(
    poses0: torch.Tensor,
    graph: PoseGraph,
    mesh,
    axis: str = "dp",
    max_iters: int = 50,
    lambda_init: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.1,
    cost_rtol: float = 1e-9,
    band: int = 10,
    robust: str = "none",
    robust_delta: float = 1.0,
) -> LMResult:
    """Banded LM with the FACTOR axis sharded over `axis` of a rank mesh
    (parallel/mesh.Mesh); the program of one rank, every rank returning the
    same result.

    Counterpart of the JAX package's optimize_sharded. Poses replicate.
    The between and loop factor axes are padded to multiples of the axis
    size with masked factors (zero residual and Jacobian blocks, so exact
    no-ops), and each rank linearizes its contiguous shard and scatters it
    through _banded_scatter, the helper of the single-device banded solve,
    into a local gradient and local super-block (A, O). One psum an LM
    iteration combines (A, O, g, cost), packed in one flat buffer; only
    then are the prior, the damping lam I and the padding identity added,
    so each counts once. The SPIKE solve and the accept and damping logic
    run on every rank on the same summed bytes, so their control flow
    cannot diverge; one more psum an iteration sums the trial cost.
    Results match optimize(solver="banded") up to the reassociation of the
    sums (within the shard, then across ranks); the iteration count can
    differ by one where that moves the step at which the relative decrease
    crosses cost_rtol.

    Banded only: a live loop wider than `band`, or reversed, raises (the
    direct solver's Woodbury panel is not sharded).
    """
    bad = _loop_span_violation(graph.loop_i, graph.loop_j, graph.loop_mask,
                               band)
    if bad is not None:
        raise ValueError(
            f"optimize_sharded is banded-only: loop spans must lie in "
            f"[0, band={band}], got [{bad[0]}, {bad[1]}] — use the "
            "single-device solver='direct' path for wide/reversed arcs")
    from ..parallel.mesh import psum

    n = poses0.shape[0]
    dtype, dev = poses0.dtype, poses0.device
    D, r = mesh.size(axis), mesh.index(axis)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)

    def pad_factors(fi, fj, meas, mask, count):
        """Factor arrays padded to `count` with masked identity factors
        on pose 0, then this rank's contiguous shard."""
        k = count - fi.shape[0]
        fi = torch.cat([fi, torch.zeros(k, **i64)])
        fj = torch.cat([fj, torch.zeros(k, **i64)])
        meas = torch.cat([meas, eye3.expand(k, 3, 3)])
        mask = torch.cat([mask, torch.zeros(k, dtype=torch.bool,
                                            device=dev)])
        b = count // D
        sl = slice(r * b, (r + 1) * b)
        return fi[sl], fj[sl], meas[sl], mask[sl].to(dtype)

    Bf = graph.between_meas.shape[0]
    Bp = max(-(-Bf // D) * D, D)
    bfi, bfj, bmeas, bw = pad_factors(
        torch.arange(Bf, **i64), torch.arange(1, Bf + 1, **i64),
        graph.between_meas, torch.ones(Bf, dtype=torch.bool, device=dev), Bp)
    Lf = graph.loop_i.shape[0]
    Lp = max(-(-max(Lf, 1) // D) * D, D)
    lfi, lfj, lmeas, lw = pad_factors(graph.loop_i, graph.loop_j,
                                      graph.loop_meas, graph.loop_mask, Lp)

    G = band
    n_sup = -(-n // G)
    n_padded = n_sup * G
    none = torch.zeros(0, **i64)
    # the damping template: eye3 at every live pose's diagonal block
    eye_live, _ = _banded_scatter(n, G, eye3.expand(n, 3, 3), none, none,
                                  eye3.new_zeros((0, 3, 3)))
    # padded-tail poses: identity diagonal, zero coupling, zero rhs
    eye_pad = torch.zeros_like(eye_live)
    for p in range(n, n_padded):
        o = 3 * (p % G)
        eye_pad[p // G, o:o + 3, o:o + 3] = eye3
    inv_btw = 1.0 / graph.between_sigmas
    inv_loop = 1.0 / graph.loop_sigmas
    inv_prior = 1.0 / graph.prior_sigmas
    T_prior_inv = se2.inverse_T(se2.T_from_pose(graph.prior_pose))
    jtj = lambda Ja, Jb: torch.einsum("bij,bik->bjk", Ja, Jb)  # noqa: E731
    jtr = lambda J, r_: torch.einsum("bij,bi->bj", J, r_)  # noqa: E731

    def prior_residual(p):
        return se2.log_se2(T_prior_inv @ se2.T_from_pose(p)) * inv_prior

    def loop_blocks(rl, Jli=None, Jlj=None):
        """Robust reweight and loop cost of the (masked) loop residuals."""
        if robust == "none":
            return rl, Jli, Jlj, 0.5 * torch.sum(rl * rl)
        w, rho = _robust_w_rho(torch.sum(rl * rl, dim=1), robust,
                               robust_delta)
        sw = torch.sqrt(w)[:, None]
        if Jli is not None:
            Jli = Jli * sw[..., None]
            Jlj = Jlj * sw[..., None]
        return rl * sw, Jli, Jlj, torch.sum(rho)

    def cost_at(x):
        rb = _factor_residual(x[bfi], x[bfj], bmeas, inv_btw) * bw[:, None]
        rl = _factor_residual(x[lfi], x[lfj], lmeas, inv_loop) * lw[:, None]
        cost_loc = 0.5 * torch.sum(rb * rb) + loop_blocks(rl)[3]
        rp = prior_residual(x[0])
        return psum(cost_loc, mesh, axis) + 0.5 * torch.dot(rp, rp)

    def linearize(x):
        rb, Jbi, Jbj = _factor_r_and_J(x[bfi], x[bfj], bmeas, inv_btw)
        rb, Jbi, Jbj = (rb * bw[:, None], Jbi * bw[:, None, None],
                        Jbj * bw[:, None, None])
        rl, Jli, Jlj = _factor_r_and_J(x[lfi], x[lfj], lmeas, inv_loop)
        rl, Jli, Jlj = (rl * lw[:, None], Jli * lw[:, None, None],
                        Jlj * lw[:, None, None])
        rl, Jli, Jlj, loop_cost = loop_blocks(rl, Jli, Jlj)
        cost_loc = 0.5 * torch.sum(rb * rb) + loop_cost
        g = x.new_zeros((n, 3))
        g.index_add_(0, bfi, jtr(Jbi, rb))
        g.index_add_(0, bfj, jtr(Jbj, rb))
        g.index_add_(0, lfi, jtr(Jli, rl))
        g.index_add_(0, lfj, jtr(Jlj, rl))
        Dg = x.new_zeros((n, 3, 3))
        Dg.index_add_(0, bfi, jtj(Jbi, Jbi))
        Dg.index_add_(0, bfj, jtj(Jbj, Jbj))
        Dg.index_add_(0, lfi, jtj(Jli, Jli))
        Dg.index_add_(0, lfj, jtj(Jlj, Jlj))
        A, O = _banded_scatter(n, G, Dg, torch.cat([bfj, lfj]),
                               torch.cat([bfi, lfi]),
                               torch.cat([jtj(Jbj, Jbi), jtj(Jlj, Jli)]))
        # the one fused collective of the iteration
        flat = psum(torch.cat([A.reshape(-1), O.reshape(-1), g.reshape(-1),
                               cost_loc.reshape(1)]), mesh, axis)
        nA, nO = A.numel(), O.numel()
        return (flat[:nA].reshape(A.shape),
                flat[nA:nA + nO].reshape(O.shape),
                flat[nA + nO:nA + nO + 3 * n].reshape(n, 3))

    x = poses0
    lam = torch.tensor(lambda_init, dtype=dtype, device=dev)
    cost = cost_at(x)
    stalls = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < max_iters:
        A, O, g = linearize(x)
        rp = prior_residual(x[0])
        Jp = jacfwd(prior_residual)(x[0])
        g[0] += Jp.T @ rp
        A = A + lam * eye_live + eye_pad
        A[0, 0:3, 0:3] += Jp.T @ Jp
        X = block_tridiag_solve(A, O[:n_sup - 1], _banded_rhs(g, n, G),
                                q=32)
        x_new = x + X.reshape(n_padded, 3)[:n]
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
