"""Wrapper of K7, the factor work of the pose graph's LM iterations
(csrc/factors.cu).

An LM iteration of models/pose_graph linearizes every factor at the
poses x, assembles the damped normal equations and evaluates the cost at
the trial poses. K7 does each of the three in one launch:

  lm_linearize      every factor's whitened residual r = Log(m^-1 T_i^-1
                    T_j) / sigma (the prior's Log(T_prior^-1 T_0) / sigma)
                    and its two 3 x 3 Jacobian blocks with respect to the
                    raw pose coordinates (x, y, theta), in closed form: the
                    derivatives torch.func.jacfwd takes of
                    pose_graph._factor_residual, on the same chart (the
                    atan2 angle, _ab's series branch at |omega| < 1e-6);
                    the loops weighted by their gate and, under a robust
                    kernel, by sqrt(w) (IRLS); the blocks, and the gradient
                    g = J^T r per pose;
  lm_banded_system  J^T J + lam I in the super-block tridiagonal storage
                    that K6 (kernels/tridiag.py) solves, the identity on the
                    padded tail poses, and the right-hand side -g;
  lm_cost           0.5 |r|^2 of the prior and between factors plus the
                    loops' (robust) cost, one number.

Every sum runs in a fixed order, gathered per pose through a pose-to-factor
index (prepare, once per optimize call) rather than scattered by atomics,
so a result repeats bit for bit from run to run. The arithmetic is
float64 inside whatever the tensors' dtype; the outputs keep the poses'
dtype.

For CUDA tensors each entry launches its kernel on the current stream,
with no host read; for CPU tensors it runs the kernel's plain version
(lm_linearize_plain, lm_banded_system_plain, lm_cost_plain), which repeats
the kernel's arithmetic in PyTorch. There is no fallback from a CUDA tensor to
the plain version: a launch failure raises. No path of the port runs the
plain versions: models/pose_graph sends CPU tensors to its op-by-op
functions (jacfwd under vmap), which the JAX parity tests hold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

ROBUST = {"none": 0, "huber": 1, "cauchy": 2}
SERIES = 1e-6  # |omega| below which _ab takes its series (utils/se2._ab)
_F64, _I32 = torch.float64, torch.int32


class FactorGraph(NamedTuple):
    """K7's view of one LM problem, built once per optimize call.

    Factor f < nb is between factor f, f >= nb loop f - nb; each joins
    poses fi[f] -> fj[f]. consts holds T_prior^-1 (3 x 3, row-major) and the
    prior's, between factors' and loops' inverse sigmas. The pose-to-factor
    index lists, for pose k, entries[start[k]:start[k + 1]], each 2 f +
    side (side 0: k = fi[f], 1: k = fj[f]), in the order between-as-i,
    between-as-j, loop-as-i, loop-as-j, each by factor: the order in which
    the op-by-op path adds into a pose."""

    n: int
    nb: int
    fi: torch.Tensor            # (F,) int32
    fj: torch.Tensor            # (F,) int32
    btw_meas: torch.Tensor      # (nb, 3, 3)
    loop_meas: torch.Tensor     # (F - nb, 3, 3)
    loop_weight: torch.Tensor   # (F - nb,) the loops' gate
    consts: torch.Tensor        # (18,)
    start: torch.Tensor         # (n + 1,) int32
    entries: torch.Tensor       # (2 F,) int32
    robust: int                 # ROBUST's code of the loops' kernel
    delta: float


def prepare(n: int, btw_fi, btw_fj, btw_meas, loop_fi, loop_fj, loop_meas,
            loop_weight, T_prior_inv, inv_prior, inv_btw, inv_loop,
            robust: str, delta: float) -> FactorGraph:
    """The FactorGraph of n poses (x's dtype and device: btw_meas's) with
    these between factors and gated loops; device operations only, no
    host read."""
    dev = btw_meas.device
    nb, nl = btw_fi.shape[0], loop_fi.shape[0]
    fi = torch.cat([btw_fi, loop_fi]).to(_I32)
    fj = torch.cat([btw_fj, loop_fj]).to(_I32)
    keys = torch.cat([btw_fi, btw_fj, loop_fi, loop_fj]).to(_I32)
    f = torch.arange(nb + nl, dtype=_I32, device=dev)
    ids = torch.cat([2 * f[:nb], 2 * f[:nb] + 1, 2 * f[nb:], 2 * f[nb:] + 1])
    sorted_keys, order = torch.sort(keys, stable=True)
    start = torch.searchsorted(
        sorted_keys, torch.arange(n + 1, dtype=_I32, device=dev),
        out_int32=True)
    consts = torch.cat([T_prior_inv.reshape(9), inv_prior, inv_btw,
                        inv_loop])
    return FactorGraph(n=n, nb=nb, fi=fi, fj=fj,
                       btw_meas=btw_meas.contiguous(),
                       loop_meas=loop_meas.contiguous(),
                       loop_weight=loop_weight.reshape(nl).contiguous(),
                       consts=consts, start=start.contiguous(),
                       entries=ids[order].contiguous(),
                       robust=ROBUST[robust], delta=float(delta))


def _check(fg: FactorGraph, x: torch.Tensor) -> int:
    """The device index of x, after checking x and fg's tensors against
    each other; raises ValueError on what the kernel does not take."""
    if x.dtype not in (torch.float32, _F64):
        raise ValueError(f"x must be float32 or float64, got {x.dtype}")
    if x.shape != (fg.n, 3):
        raise ValueError(f"x must be ({fg.n}, 3), got {tuple(x.shape)}")
    index = x.get_device()
    F, nb = fg.fi.shape[0], fg.nb
    for name, t, shape, dtype in (
            ("x", x, (fg.n, 3), x.dtype),
            ("fi", fg.fi, (F,), _I32), ("fj", fg.fj, (F,), _I32),
            ("btw_meas", fg.btw_meas, (nb, 3, 3), x.dtype),
            ("loop_meas", fg.loop_meas, (F - nb, 3, 3), x.dtype),
            ("loop_weight", fg.loop_weight, (F - nb,), x.dtype),
            ("consts", fg.consts, (18,), x.dtype),
            ("start", fg.start, (fg.n + 1,), _I32),
            ("entries", fg.entries, (2 * F,), _I32)):
        if t.shape != shape or t.dtype is not dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    return index


def _graph_args(fg: FactorGraph):
    return (fg.fi.data_ptr(), fg.fj.data_ptr(), fg.btw_meas.data_ptr(),
            fg.loop_meas.data_ptr(), fg.loop_weight.data_ptr(),
            fg.consts.data_ptr(), fg.start.data_ptr(), fg.entries.data_ptr(),
            fg.n, fg.nb, fg.fi.shape[0], fg.robust, fg.delta)


def _split(buf: torch.Tensor, n: int, nb: int, nl: int):
    """((Jp, Jbi, Jbj, Jli, Jlj), g) as views of one flat buffer."""
    parts = buf.split([9, 9 * nb, 9 * nb, 9 * nl, 9 * nl, 3 * n])
    J = tuple(p.view(-1, 3, 3) for p in parts[:5])
    return (J[0].view(3, 3),) + J[1:], parts[5].view(n, 3)


def lm_linearize(fg: FactorGraph, x: torch.Tensor):
    """((Jp, Jbi, Jbj, Jli, Jlj), g) at the poses x (n, 3): the Jacobian
    blocks (3, 3), (nb, 3, 3) x 2 and (nl, 3, 3) x 2 of the prior, between
    and loop factors and the gradient J^T r (n, 3), in x's dtype, as
    models/pose_graph._linearize returns them."""
    if not x.is_cuda:
        return lm_linearize_plain(fg, x)
    index = _check(fg, x)
    nb, nl = fg.nb, fg.fi.shape[0] - fg.nb
    buf = torch.empty(9 * (1 + 2 * nb + 2 * nl) + 3 * fg.n, dtype=x.dtype,
                      device=x.device)
    _LINEARIZE(index, x.data_ptr(), *_graph_args(fg), int(x.dtype is _F64),
               buf.data_ptr())
    lm_linearize.launches += 1
    return _split(buf, fg.n, nb, nl)


def lm_banded_system(fg: FactorGraph, J, g: torch.Tensor,
                     lam: torch.Tensor, band: int, pad: bool = True):
    """(A_sup, O_sup, R) of the damped system J^T J + lam I for K6:
    A_sup (n_sup, 3 band, 3 band) the super-block diagonal, O_sup
    (max(n_sup - 1, 1), ...) the sub-diagonal (O_sup[s] couples super-block
    s + 1 to s), R (n_sup, 3 band, 1) the right-hand side -g; the padded
    tail poses get the identity on the diagonal when `pad`, and zero
    coupling and right-hand side. lam is a 0-d tensor in x's dtype."""
    if not g.is_cuda:
        return lm_banded_system_plain(fg, J, g, lam, band, pad)
    index = _check(fg, g)
    nb, nl = fg.nb, fg.fi.shape[0] - fg.nb
    Jp, Jbi, Jbj, Jli, Jlj = J
    for name, t, shape in (("Jp", Jp, (3, 3)), ("Jbi", Jbi, (nb, 3, 3)),
                           ("Jbj", Jbj, (nb, 3, 3)), ("Jli", Jli, (nl, 3, 3)),
                           ("Jlj", Jlj, (nl, 3, 3)), ("lam", lam, ())):
        if t.shape != shape or t.dtype is not g.dtype:
            raise ValueError(f"{name} must be {shape} {g.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {g.device}")
    if band < 1:
        raise ValueError(f"band must be at least 1, got {band}")
    n_sup, bs = -(-fg.n // band), 3 * band
    A = torch.empty((n_sup, bs, bs), dtype=g.dtype, device=g.device)
    O = torch.empty((max(n_sup - 1, 1), bs, bs), dtype=g.dtype,
                    device=g.device)
    R = torch.empty((n_sup, bs, 1), dtype=g.dtype, device=g.device)
    _BANDED_SYSTEM(index, g.data_ptr(), *_graph_args(fg),
                   int(g.dtype is _F64), Jp.data_ptr(), Jbi.data_ptr(),
                   Jbj.data_ptr(), Jli.data_ptr(), Jlj.data_ptr(),
                   lam.data_ptr(), band, int(pad), A.data_ptr(),
                   O.data_ptr(), R.data_ptr())
    lm_banded_system.launches += 1
    return A, O, R


def lm_cost(fg: FactorGraph, x: torch.Tensor) -> torch.Tensor:
    """The cost at the poses x, a 0-d tensor in x's dtype:
    models/pose_graph._cost without its psum."""
    if not x.is_cuda:
        return lm_cost_plain(fg, x)
    index = _check(fg, x)
    out = torch.empty((), dtype=x.dtype, device=x.device)
    _COST(index, x.data_ptr(), *_graph_args(fg), int(x.dtype is _F64),
          out.data_ptr())
    lm_cost.launches += 1
    return out


_LINEARIZE = build.Entry("slam_factors_linearize")
_BANDED_SYSTEM = build.Entry("slam_factors_banded_system")
_COST = build.Entry("slam_factors_cost")
lm_linearize.launches = lm_banded_system.launches = lm_cost.launches = 0


# -- the plain versions: the kernel's arithmetic in PyTorch ----------------

def _minv(M: torch.Tensor) -> torch.Tensor:
    """(F, 2, 3) [A | b] of the inverses of SE(2) matrices M (F, 3, 3):
    A = R^T, b = -R^T t, as utils/se2.inverse_T forms them."""
    A = M[:, :2, :2].transpose(1, 2)
    b = -(A[:, :, 0] * M[:, None, 0, 2] + A[:, :, 1] * M[:, None, 1, 2])
    return torch.cat([A, b[:, :, None]], dim=2)


def _factor_plain(xi, xj, Minv, s):
    """(r (F, 3), Ji (F, 3, 3), Jj (F, 3, 3)), float64, of the whitened
    residuals Log(Minv T(xi)^-1 T(xj)) * s, in closed form (csrc/factors.cu
    derives each term)."""
    ci, si = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    cj, sj = torch.cos(xj[:, 2]), torch.sin(xj[:, 2])
    dx, dy = xj[:, 0] - xi[:, 0], xj[:, 1] - xi[:, 1]
    ux, uy = ci * dx + si * dy, ci * dy - si * dx  # T_i^-1 t_j
    r00, r01 = ci * cj + si * sj, si * cj - ci * sj  # R_i^T R_j
    r10, r11 = ci * sj - si * cj, ci * cj + si * sj
    A00, A01, b0 = Minv[:, 0, 0], Minv[:, 0, 1], Minv[:, 0, 2]
    A10, A11, b1 = Minv[:, 1, 0], Minv[:, 1, 1], Minv[:, 1, 2]
    E00, E01 = A00 * r00 + A01 * r10, A00 * r01 + A01 * r11
    E10, E11 = A10 * r00 + A11 * r10, A10 * r01 + A11 * r11
    tx, ty = A00 * ux + A01 * uy + b0, A10 * ux + A11 * uy + b1
    om = torch.atan2(E10, E00)
    q = (E00 * E11 - E10 * E01) / (E00 * E00 + E10 * E10)  # d omega / d th_j
    small = torch.abs(om) < SERIES
    w = torch.where(small, torch.ones_like(om), om)
    sw, cw = torch.sin(w), torch.cos(w)
    a = torch.where(small, 1.0 - om * om / 6.0, sw / w)
    b = torch.where(small, om / 2.0, (1.0 - cw) / w)
    da = torch.where(small, -om / 3.0, (cw - a) / w)
    db = torch.where(small, torch.full_like(om, 0.5), (sw - b) / w)
    den = a * a + b * b
    vx, vy = (a * tx + b * ty) / den, (a * ty - b * tx) / den
    dden = 2.0 * (a * da + b * db)
    gx = (da * tx + db * ty - vx * dden) / den  # d v / d omega
    gy = (da * ty - db * tx - vy * dden) / den
    P00, P01 = A00 * ci - A01 * si, A00 * si + A01 * ci  # d t / d t_j
    P10, P11 = A10 * ci - A11 * si, A10 * si + A11 * ci
    tqx, tqy = A00 * uy - A01 * ux, A10 * uy - A11 * ux  # d t / d th_i
    z = torch.zeros_like(om)
    Jj = torch.stack([
        torch.stack([(a * P00 + b * P10) / den, (a * P01 + b * P11) / den,
                     gx * q], -1),
        torch.stack([(a * P10 - b * P00) / den, (a * P11 - b * P01) / den,
                     gy * q], -1),
        torch.stack([z, z, q], -1)], -2)
    Ji = torch.stack([
        torch.stack([-Jj[:, 0, 0], -Jj[:, 0, 1],
                     (a * tqx + b * tqy) / den - gx * q], -1),
        torch.stack([-Jj[:, 1, 0], -Jj[:, 1, 1],
                     (a * tqy - b * tqx) / den - gy * q], -1),
        torch.stack([z, z, -q], -1)], -2)
    r = torch.stack([vx, vy, om], -1) * s
    return r, Ji * s[..., None], Jj * s[..., None]


def _robust_plain(e2, robust: int, delta: float):
    """(w, rho) of the Huber (1) or Cauchy (2) kernel at squared whitened
    norms e2, float64; pose_graph._robust_w_rho's formulas."""
    if robust == 1:
        e = torch.sqrt(e2)
        out = e > delta
        w = torch.where(out, delta / torch.clamp(e, min=1e-30),
                        torch.ones_like(e))
        rho = torch.where(out, delta * e - 0.5 * delta * delta, 0.5 * e2)
    else:
        t = e2 / (delta * delta)
        w, rho = 1.0 / (1.0 + t), 0.5 * delta * delta * torch.log1p(t)
    return w, rho


def _all_factors_plain(fg: FactorGraph, x: torch.Tensor):
    """(rp, Jp, r, Ji, Jj, e2) in float64: the prior's residual and block,
    every factor's weighted (and, for the loops, robustly reweighted)
    residual and blocks, and the loops' squared norms before reweighting
    (zeros for the between factors)."""
    x64, c = x.to(_F64), fg.consts.to(_F64)
    nb = fg.nb
    Tp = c[:9].view(3, 3)
    rp, _, Jp = _factor_plain(torch.zeros_like(x64[:1]), x64[:1],
                              Tp[None, :2], c[9:12])
    fi, fj = fg.fi.long(), fg.fj.long()
    meas = torch.cat([fg.btw_meas, fg.loop_meas]).to(_F64)
    s = torch.cat([c[12:15].expand(nb, 3), c[15:18].expand(len(fi) - nb, 3)])
    r, Ji, Jj = _factor_plain(x64[fi], x64[fj], _minv(meas), s)
    w = torch.cat([torch.ones(nb, dtype=_F64, device=x.device),
                   fg.loop_weight.to(_F64)])[:, None]
    r, Ji, Jj = r * w, Ji * w[..., None], Jj * w[..., None]
    e2 = torch.sum(r * r, dim=1) * (torch.arange(len(fi), device=x.device)
                                    >= nb)
    if fg.robust:
        rw = torch.sqrt(_robust_plain(e2, fg.robust, fg.delta)[0])[:, None]
        rw[:nb] = 1.0
        r, Ji, Jj = r * rw, Ji * rw[..., None], Jj * rw[..., None]
    return rp[0], Jp[0], r, Ji, Jj, e2


def lm_linearize_plain(fg: FactorGraph, x: torch.Tensor):
    """lm_linearize as the kernel computes it, on any device: float64
    inside, the gradient gathered per pose in the index's order after the
    prior."""
    rp, Jp, r, Ji, Jj, _ = _all_factors_plain(fg, x)
    side = fg.entries.long() % 2
    f = fg.entries.long() // 2
    contrib = torch.where(side[:, None].bool(),
                          torch.einsum("eij,ei->ej", Jj[f], r[f]),
                          torch.einsum("eij,ei->ej", Ji[f], r[f]))
    pose = torch.repeat_interleave(
        torch.arange(fg.n, device=x.device),
        (fg.start[1:] - fg.start[:-1]).long())
    g = torch.zeros((fg.n, 3), dtype=_F64, device=x.device)
    g[0] = Jp.T @ rp
    g.index_add_(0, pose, contrib)
    nb, dt = fg.nb, x.dtype
    return ((Jp.to(dt), Ji[:nb].to(dt), Jj[:nb].to(dt), Ji[nb:].to(dt),
             Jj[nb:].to(dt)), g.to(dt))


def lm_banded_system_plain(fg: FactorGraph, J, g: torch.Tensor,
                        lam: torch.Tensor, band: int, pad: bool = True):
    """lm_banded_system as the kernel computes it, on any device: each 3 x 3
    block of J^T J summed in float64 from J's blocks, the diagonal's in the
    index's order after the prior, then lam."""
    n, G, dev, dt = fg.n, band, g.device, g.dtype
    n_sup, bs = -(-n // G), 3 * band
    Jp, Jbi, Jbj, Jli, Jlj = (t.to(_F64) for t in J)
    Ji, Jj = torch.cat([Jbi, Jli]), torch.cat([Jbj, Jlj])
    fi, fj = fg.fi.long(), fg.fj.long()
    jtj = lambda a, b: torch.einsum("fki,fkj->fij", a, b)  # noqa: E731
    side = fg.entries.long() % 2
    f = fg.entries.long() // 2
    own = torch.where(side[:, None, None].bool(), jtj(Jj[f], Jj[f]),
                      jtj(Ji[f], Ji[f]))
    # a self-loop (fi = fj) adds both cross terms to its pose's block
    self_loop = ((side == 0) & (fi[f] == fj[f]))[:, None, None]
    cross = jtj(Jj[f], Ji[f])
    own = own + torch.where(self_loop, cross + cross.transpose(1, 2), 0.0)
    pose = torch.repeat_interleave(torch.arange(n, device=dev),
                                   (fg.start[1:] - fg.start[:-1]).long())
    D = torch.zeros((n_sup * G, 3, 3), dtype=_F64, device=dev)
    D[0] = Jp.T @ Jp
    D.index_add_(0, pose, own)
    eye = torch.eye(3, dtype=_F64, device=dev)
    D[:n] += lam.to(_F64) * eye
    if pad:
        D[n:] = eye
    A = torch.zeros((n_sup, bs, bs), dtype=_F64, device=dev)
    for o in range(G):
        A[:, 3 * o:3 * o + 3, 3 * o:3 * o + 3] = D[o::G]
    O = torch.zeros((max(n_sup - 1, 1), bs, bs), dtype=_F64, device=dev)
    # H[hi, lo] of each factor joining two poses: J_j^T J_i where fj > fi,
    # J_i^T J_j where fi > fj; within a super-block also its transpose
    lo, hi = torch.minimum(fi, fj), torch.maximum(fi, fj)
    M = torch.where((fj > fi)[:, None, None], jtj(Jj, Ji), jtj(Ji, Jj))
    M = torch.where((hi > lo)[:, None, None], M, 0.0)
    s_r, s_c = hi // G, lo // G
    ii = torch.arange(3, device=dev)[:, None]
    r3 = (3 * (hi % G))[:, None, None] + ii
    c3 = (3 * (lo % G))[:, None, None] + ii
    same, adj = (s_r == s_c)[:, None, None], (s_r == s_c + 1)[:, None, None]
    s_same = s_r[:, None, None]
    A.index_put_((s_same, r3, c3.mT), torch.where(same, M, 0.0),
                 accumulate=True)
    A.index_put_((s_same, c3, r3.mT), torch.where(same, M.mT, 0.0),
                 accumulate=True)
    O.index_put_((torch.where(adj, s_c[:, None, None], 0), r3, c3.mT),
                 torch.where(adj, M, 0.0), accumulate=True)
    R = torch.zeros((n_sup * G, 3), dtype=_F64, device=dev)
    R[:n] = -g.to(_F64)
    return A.to(dt), O.to(dt), R.view(n_sup, bs, 1).to(dt)


def lm_cost_plain(fg: FactorGraph, x: torch.Tensor) -> torch.Tensor:
    """lm_cost as the kernel computes it, on any device: each factor's
    cost in float64, summed, rounded once to x's dtype."""
    rp, _, r, _, _, e2 = _all_factors_plain(fg, x)
    per = 0.5 * torch.sum(r * r, dim=1)
    if fg.robust:
        per[fg.nb:] = _robust_plain(e2[fg.nb:], fg.robust, fg.delta)[1]
    return (0.5 * torch.dot(rp, rp) + torch.sum(per)).to(x.dtype)
