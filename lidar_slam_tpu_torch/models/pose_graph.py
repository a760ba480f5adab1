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
robust kernels reweight the loop factors (IRLS). On CPU tensors the factor
Jacobian blocks come from torch.func (jacfwd under vmap), one batched pass
per LM step.

One LM core (_levenberg_marquardt: _linearize, _cost, _banded_system)
serves optimize and the factor-sharded optimize_sharded, which pass in
only how the damped system is solved and whether the cost goes through a
psum. The loop reads its done flag once per iteration; CG reads its
residual norm once per CG iteration. On CUDA tensors the block-tridiagonal
SPIKE solve behind "banded" and "direct" is K6 (kernels/tridiag.py): three
launches, float64 inside, no host read; and the factor work of each
iteration is K7 (kernels/factors.py): one launch linearizes every factor
(the blocks every solver takes and the gradient), one assembles the banded
system, one evaluates the cost, all in closed form and float64 inside.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..config import PoseGraphConfig
from ..kernels import factors, tridiag
from ..utils import se2, tracing


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
    p = _problem(poses, g)
    return torch.cat([
        _prior_residual(poses[0], p.T_prior_inv, p.inv_prior),
        _set_residual(poses, p.btw).reshape(-1),
        _set_residual(poses, p.loops).reshape(-1)])


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


def _thomas(A, O, R):
    """Block-tridiagonal solve T X = R by block LDL^T (Thomas).

    A (..., n, b, b) diagonal blocks, O (..., n-1, b, b) sub-diagonal
    (O_i = T[i+1, i]), R (..., n, b, m); the chain axis is -3 and any
    leading axes are batched.
    """
    n = A.shape[-3]
    T_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    # block inverses: adjugate for 3x3 blocks, LU beyond
    binv = _inv3x3b if A.shape[-1] == 3 else torch.linalg.inv
    Dinv = [binv(A[..., 0, :, :])]
    z = [R[..., 0, :, :]]
    L = []
    for i in range(1, n):
        O_p = O[..., i - 1, :, :]
        L_i = O_p @ Dinv[-1]
        Dinv.append(binv(A[..., i, :, :] - L_i @ T_(O_p)))
        z.append(R[..., i, :, :] - L_i @ z[-1])
        L.append(L_i)
    w = torch.stack(Dinv, dim=-3) @ torch.stack(z, dim=-3)
    x = [w[..., n - 1, :, :]]
    for i in range(n - 2, -1, -1):
        x.append(w[..., i, :, :] - T_(L[i]) @ x[-1])
    return torch.stack(x[::-1], dim=-3)


def kernel_path(device: torch.device, dtype: torch.dtype, b: int) -> bool:
    """Whether block_tridiag_solve runs K6 (kernels/tridiag.py) rather
    than op by op: CUDA float32 or float64 tensors with blocks at most
    kernels/tridiag.MAX_B wide."""
    return (device.type == "cuda" and dtype in (torch.float32, torch.float64)
            and b <= tridiag.MAX_B)


def factor_kernel_path(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether the LM's factor work (_linearize, _cost, _banded_system)
    runs K7 (kernels/factors.py) rather than op by op: CUDA float32 or
    float64 poses."""
    return device.type == "cuda" and dtype in (torch.float32, torch.float64)


def block_tridiag_solve(A, O, R, q: int = 64):
    """SPD block-tridiagonal solve T X = R, exact.

    A (n, b, b), O (n-1, b, b) with O_i = T[i+1, i], R (n, b, m). For
    n > 2q a two-level SPIKE decomposition: the chain splits into segments
    of q blocks whose q-1 interior blocks are eliminated by one Thomas solve
    batched across segments, leaving a reduced block-tridiagonal system on
    the segment-end interface blocks. Sequential depth ~2(q + n/q) instead
    of 2n, with the same arithmetic as the dense factorization.

    On the kernel path (kernel_path) the same split runs as K6, three
    launches in float64 with no host read; elsewhere op by op in the
    inputs' dtype.
    """
    if kernel_path(A.device, A.dtype, A.shape[-1]):
        tracing.count("pose_graph.solves_on_kernel")
        return tridiag.block_tridiag(A.contiguous(), O.contiguous(),
                                     R.contiguous(), q)
    return _block_tridiag_ops(A, O, R, q)


def _block_tridiag_ops(A, O, R, q: int):
    """block_tridiag_solve op by op, in the inputs' dtype."""
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
    """Scatter per-pose (3, 3) diagonal blocks D (n or n_sup band, 3, 3)
    and off-diagonal pose-pair blocks off_M[f] = H[off_r[f], off_c[f]]
    (off_r >= off_c, off_r - off_c <= band) into super-block tridiagonal
    storage: (A_sup (n_sup, 3 band, 3 band), O_sup (max(n_sup-1, 1), ...)).
    """
    G, dev = band, D.device
    n_sup = -(-n // G)
    bs = 3 * G
    ii = torch.arange(3, device=dev)[:, None]
    jj = torch.arange(3, device=dev)[None, :]
    ar = torch.arange(D.shape[0], device=dev)
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
    tracing.count("host.syncs")  # indexing by the mask reads its count
    if span.numel() == 0:
        return None
    lo, hi = int(span.min()), int(span.max())
    tracing.count("host.syncs", 2)
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
    while k < maxiter:
        tracing.count("host.syncs")
        if not bool(_vdot(r, r) > atol2):
            break
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


class _Factors(NamedTuple):
    """A factor set: pose pairs fi -> fj (F,), SE(2) measurements
    (F, 3, 3), inverse sigmas (3,), a weight (F, 1) a factor or None."""

    fi: torch.Tensor
    fj: torch.Tensor
    meas: torch.Tensor
    inv_sigmas: torch.Tensor
    weight: torch.Tensor | None


class _Problem(NamedTuple):
    """The graph as the LM core sees it: the prior (T_prior^-1 and its
    inverse sigmas), the factor sets, the loops' robust kernel and width;
    on the factor kernel path, K7's view of them."""

    T_prior_inv: torch.Tensor
    inv_prior: torch.Tensor
    btw: _Factors
    loops: _Factors
    robust: str
    delta: float
    eye3: torch.Tensor
    kernel: factors.FactorGraph | None = None


def _on_kernel(p: _Problem, n: int) -> _Problem:
    """p with K7's FactorGraph of its factor sets (no host read)."""
    return p._replace(kernel=factors.prepare(
        n, p.btw.fi, p.btw.fj, p.btw.meas, p.loops.fi, p.loops.fj,
        p.loops.meas, p.loops.weight, p.T_prior_inv, p.inv_prior,
        p.btw.inv_sigmas, p.loops.inv_sigmas, p.robust, p.delta))


def _problem(x, graph: PoseGraph, robust: str = "none",
             delta: float = 1.0) -> _Problem:
    """The whole graph for poses x (n, 3), the loops weighted by their gate."""
    dtype, dev = x.dtype, x.device
    idx_i = torch.arange(x.shape[0] - 1, device=dev)
    return _Problem(
        T_prior_inv=se2.inverse_T(se2.T_from_pose(graph.prior_pose)),
        inv_prior=1.0 / graph.prior_sigmas,
        btw=_Factors(idx_i, idx_i + 1, graph.between_meas,
                     1.0 / graph.between_sigmas, None),
        loops=_Factors(graph.loop_i, graph.loop_j, graph.loop_meas,
                       1.0 / graph.loop_sigmas,
                       graph.loop_mask.to(dtype)[:, None]),
        robust=robust, delta=delta,
        eye3=torch.eye(3, dtype=dtype, device=dev))


_jtj = lambda Ja, Jb: torch.einsum("bij,bik->bjk", Ja, Jb)  # noqa: E731
_jtr = lambda J, r: torch.einsum("bij,bi->bj", J, r)  # noqa: E731
_jv = lambda J, v: torch.einsum("bij,bj->bi", J, v)  # noqa: E731


def _prior_residual(p, T_prior_inv, inv_prior):
    """Whitened prior residual Log(T_prior^-1 T(p)) / sigma of pose p."""
    return se2.log_se2(T_prior_inv @ se2.T_from_pose(p)) * inv_prior


def _set_residual(x, f: _Factors):
    """Whitened (and weighted) residuals (F, 3) of factor set f at x."""
    r = _factor_residual(x[f.fi], x[f.fj], f.meas, f.inv_sigmas)
    return r if f.weight is None else r * f.weight


def _linearize(x, p: _Problem):
    """(J, g): the Jacobian blocks (Jp, Jbi, Jbj, Jli, Jlj) of the prior,
    between and loop factors at x, and the gradient J^T r (n, 3) summed in
    that order. A robust kernel scales the loops' weighted blocks and
    residuals by sqrt(w) (IRLS: every solver sees the reweighted system).
    On the factor kernel path one K7 launch."""
    if p.kernel is not None:
        tracing.count("pose_graph.linearizations_on_kernel")
        return factors.lm_linearize(p.kernel, x)
    rp = _prior_residual(x[0], p.T_prior_inv, p.inv_prior)
    Jp = jacfwd(_prior_residual)(x[0], p.T_prior_inv, p.inv_prior)
    g = x.new_zeros(x.shape)
    g[0] += Jp.T @ rp
    J = [Jp]
    for f, robust in ((p.btw, "none"), (p.loops, p.robust)):
        r, Ji, Jj = _factor_r_and_J(x[f.fi], x[f.fj], f.meas, f.inv_sigmas)
        if f.weight is not None:
            w = f.weight
            r, Ji, Jj = r * w, Ji * w[..., None], Jj * w[..., None]
        if robust != "none":
            w, _ = _robust_w_rho(torch.sum(r * r, dim=1), robust, p.delta)
            sw = torch.sqrt(w)[:, None]
            r, Ji, Jj = r * sw, Ji * sw[..., None], Jj * sw[..., None]
        g.index_add_(0, f.fi, _jtr(Ji, r))
        g.index_add_(0, f.fj, _jtr(Jj, r))
        J += [Ji, Jj]
    return tuple(J), g


def _cost(x, p: _Problem, reduce=None):
    """0.5 |r|^2 of the prior and between factors plus the loop factors'
    (robust) cost at x; reduce (a psum) sums it across ranks. On the
    factor kernel path one K7 launch."""
    if p.kernel is not None:
        cost = factors.lm_cost(p.kernel, x)
    else:
        rp = _prior_residual(x[0], p.T_prior_inv, p.inv_prior)
        rb = _set_residual(x, p.btw)
        rl = _set_residual(x, p.loops)
        if p.robust == "none":
            loop_cost = 0.5 * torch.sum(rl * rl)
        else:
            _, rho = _robust_w_rho(torch.sum(rl * rl, dim=1), p.robust,
                                   p.delta)
            loop_cost = torch.sum(rho)
        cost = 0.5 * (torch.dot(rp, rp) + torch.sum(rb * rb)) + loop_cost
    return cost if reduce is None else reduce(cost)


def _diagonal_blocks(p: _Problem, J, lam, n: int, with_loops: bool = True):
    """lam I plus the (3, 3) diagonal blocks of J^T J, per pose."""
    Jp, Jbi, Jbj, Jli, Jlj = J
    D = lam * p.eye3.expand(n, 3, 3).clone()
    D[0] += Jp.T @ Jp
    D.index_add_(0, p.btw.fi, _jtj(Jbi, Jbi))
    D.index_add_(0, p.btw.fj, _jtj(Jbj, Jbj))
    if with_loops:
        D.index_add_(0, p.loops.fi, _jtj(Jli, Jli))
        D.index_add_(0, p.loops.fj, _jtj(Jlj, Jlj))
    return D


def _banded_system(p: _Problem, J, g, lam, n: int, band: int,
                   pad: bool = True):
    """J^T J + lam I in super-block tridiagonal storage (A_sup, O_sup),
    with the identity on the padded tail poses when `pad`, and its
    right-hand side R (n_sup, 3 band, 1): -g, zero on the padded tail. On
    the factor kernel path one K7 launch."""
    if p.kernel is not None:
        return factors.lm_banded_system(p.kernel, J, g, lam, band, pad)
    _, Jbi, Jbj, Jli, Jlj = J
    D = _diagonal_blocks(p, J, lam, n)
    if pad and n % band:
        # padded tail poses: identity diagonal, zero coupling, zero rhs
        D = torch.cat([D, p.eye3.expand(-n % band, 3, 3)])
    A_sup, O_sup = _banded_scatter(
        n, band, D, torch.cat([p.btw.fj, p.loops.fj]),
        torch.cat([p.btw.fi, p.loops.fi]),
        torch.cat([_jtj(Jbj, Jbi), _jtj(Jlj, Jli)]))
    n_sup = A_sup.shape[0]
    R = torch.cat([-g, g.new_zeros((n_sup * band - n, 3))]).reshape(
        n_sup, 3 * band, 1)
    return A_sup, O_sup, R


def _banded_solve(A_sup, O_sup, R, n: int, band: int):
    """The step (n, 3) of the banded system (A_sup, O_sup, R)."""
    n_sup = A_sup.shape[0]
    X = block_tridiag_solve(A_sup, O_sup[:n_sup - 1], R, q=32)
    return X.reshape(n_sup * band, 3)[:n]


def _direct_solve(p: _Problem, J, g, lam):
    """Exact Newton step: SPIKE over the chain's block-tridiagonal part of
    J^T J + lam I with the right-hand sides [-g | U], U's columns the loop
    Jacobians transposed (1 + 3L columns, every loop candidate, live or
    not), then the Woodbury correction x = y_b - Y_u (I + U^T Y_u)^-1 U^T
    y_b."""
    Jp, Jbi, Jbj, Jli, Jlj = J
    n, n_loops, dev = g.shape[0], Jli.shape[0], g.device
    A = _diagonal_blocks(p, J, lam, n, False)
    O = _jtj(Jbj, Jbi)  # O_i = H[i+1, i]
    if n_loops:
        R = g.new_zeros((n, 3, 1 + 3 * n_loops))
        R[:, :, 0] = -g
        rows = torch.arange(3, device=dev)[None, :, None]
        cols = (1 + 3 * torch.arange(n_loops, device=dev)[:, None]
                + torch.arange(3, device=dev)[None, :])[:, None, :]
        R.index_put_((p.loops.fi[:, None, None], rows, cols),
                     Jli.transpose(1, 2), accumulate=True)
        R.index_put_((p.loops.fj[:, None, None], rows, cols),
                     Jlj.transpose(1, 2), accumulate=True)
    else:
        R = (-g)[:, :, None]
    Y = block_tridiag_solve(A, O, R)
    yb = Y[:, :, 0]
    if not n_loops:
        return yb
    UtY = (torch.einsum("lab,lbm->lam", Jli, Y[p.loops.fi])
           + torch.einsum("lab,lbm->lam", Jlj, Y[p.loops.fj]))
    UtY = UtY.reshape(3 * n_loops, -1)
    S = torch.eye(3 * n_loops, dtype=g.dtype, device=dev) + UtY[:, 1:]
    zc = torch.linalg.solve(S, UtY[:, 0])
    return yb - torch.einsum("nim,m->ni", Y[:, :, 1:], zc)


def _cg_step(p: _Problem, J, g, lam, x0, tol: float, maxiter: int):
    """Block-Jacobi preconditioned CG on J^T J + lam I, from x0."""
    Jp, Jbi, Jbj, Jli, Jlj = J
    bi, bj, li, lj = p.btw.fi, p.btw.fj, p.loops.fi, p.loops.fj
    Dinv = _inv3x3b(_diagonal_blocks(p, J, lam, g.shape[0]))

    def matvec(v):
        # u_f = J_i v_i + J_j v_j per factor; y_i += J_i^T u_f etc.
        y = lam * v
        y[0] += Jp.T @ (Jp @ v[0])
        ub = _jv(Jbi, v[bi]) + _jv(Jbj, v[bj])
        y.index_add_(0, bi, _jtr(Jbi, ub))
        y.index_add_(0, bj, _jtr(Jbj, ub))
        ul = _jv(Jli, v[li]) + _jv(Jlj, v[lj])
        y.index_add_(0, li, _jtr(Jli, ul))
        y.index_add_(0, lj, _jtr(Jlj, ul))
        return y

    return cg_solve(matvec, -g, x0,
                    lambda v: torch.einsum("nij,nj->ni", Dinv, v), tol,
                    maxiter)


def _levenberg_marquardt(poses0, p: _Problem, solve, reduce, max_iters: int,
                         lambda_init: float, lambda_up: float,
                         lambda_down: float, cost_rtol: float) -> LMResult:
    """The LM loop of optimize and optimize_sharded. solve(p, J, g, lam,
    dx_prev) returns the damped system's step (dx_prev, CG's warm start:
    the last rejected step, zero after an accepted one); reduce sums the
    cost across ranks (None on one device). One done read an iteration. On
    the factor kernel path p carries K7's view of the graph, built here
    once."""
    x, dev = poses0, poses0.device
    if factor_kernel_path(dev, poses0.dtype):
        p = _on_kernel(p, poses0.shape[0])
    lam = torch.tensor(lambda_init, dtype=poses0.dtype, device=dev)
    cost = _cost(x, p, reduce)
    stalls = torch.zeros((), dtype=torch.int64, device=dev)
    dx_prev = torch.zeros_like(poses0)
    it = 0
    while it < max_iters:
        J, g = _linearize(x, p)
        with tracing.span("pose_graph.solve"):
            dx = solve(p, J, g, lam, dx_prev)
        x_new = x + dx
        cost_new = _cost(x_new, p, reduce)
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
        tracing.count("pose_graph.iterations")
        tracing.count("host.syncs")
        if bool(done):
            break
    return LMResult(poses=x, cost=cost, iterations=it, final_lambda=lam)


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
    if solver == "banded" and not banded_exact(graph, band):
        solver = "direct"
    n = poses0.shape[0]
    p = _problem(poses0, graph, robust, robust_delta)

    def solve(p, J, g, lam, dx_prev):
        if solver == "banded":
            return _banded_solve(*_banded_system(p, J, g, lam, n, band), n,
                                 band)
        if solver == "direct":
            return _direct_solve(p, J, g, lam)
        return _cg_step(p, J, g, lam, dx_prev, cg_tol, cg_iters)

    return _levenberg_marquardt(poses0, p, solve, None, max_iters,
                                lambda_init, lambda_up, lambda_down,
                                cost_rtol)


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


def _require_banded(loop_i, loop_j, loop_mask, band: int, entry: str):
    """Raise, naming `entry`, when a live loop lies outside [0, band]."""
    bad = _loop_span_violation(loop_i, loop_j, loop_mask, band)
    if bad is not None:
        raise ValueError(
            f"{entry} is banded-only: loop spans must lie in "
            f"[0, band={band}], got [{bad[0]}, {bad[1]}] — use the "
            "single-device solver='direct' path for wide or reversed arcs")


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

    Counterpart of the JAX package's optimize_sharded, on optimize's LM
    core. Poses replicate. Each rank assembles a contiguous block of
    ceil(F / axis size) factors of each set (the last may be shorter or
    empty) through _banded_system into a local (A, O) and right-hand side
    R = -g; rank 0 alone adds the prior, lam I and the padding identity, so
    each counts once. One psum an LM iteration sums (A, O, R) in one flat
    buffer, and the solve and the accept logic run on every rank on the
    same bytes, so their control flow cannot diverge; one more psum sums
    the trial cost.
    Results match optimize(solver="banded") up to the reassociation of the
    sums; the iteration count can differ by one where that moves the step
    at which the relative decrease crosses cost_rtol.

    Banded only: a live loop wider than `band`, or reversed, raises (the
    direct solver's Woodbury panel is not sharded).
    """
    _require_banded(graph.loop_i, graph.loop_j, graph.loop_mask, band,
                    "optimize_sharded")
    from ..parallel.mesh import psum

    n = poses0.shape[0]
    D, r = mesh.size(axis), mesh.index(axis)
    lead = r == 0

    def shard(f: _Factors) -> _Factors:
        b = -(-f.fi.shape[0] // D)
        sl = slice(r * b, (r + 1) * b)
        return f._replace(fi=f.fi[sl], fj=f.fj[sl], meas=f.meas[sl],
                          weight=None if f.weight is None else f.weight[sl])

    p = _problem(poses0, graph, robust, robust_delta)
    p = p._replace(inv_prior=p.inv_prior * float(lead), btw=shard(p.btw),
                   loops=shard(p.loops))

    def solve(p, J, g, lam, dx_prev):
        A, O, R = _banded_system(p, J, g, lam * float(lead), n, band,
                                 pad=lead)
        # the one fused collective of the iteration
        A_, O_, R_ = psum(torch.cat([A.reshape(-1), O.reshape(-1),
                                     R.reshape(-1)]), mesh, axis).split(
            [A.numel(), O.numel(), R.numel()])
        return _banded_solve(A_.view(A.shape), O_.view(O.shape),
                             R_.view(R.shape), n, band)

    return _levenberg_marquardt(poses0, p, solve,
                                lambda c: psum(c, mesh, axis), max_iters,
                                lambda_init, lambda_up, lambda_down,
                                cost_rtol)
