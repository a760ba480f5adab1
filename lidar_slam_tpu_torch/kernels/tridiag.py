"""Wrapper of K6, the pose graph's block-tridiagonal SPIKE solve
(csrc/tridiag.cu).

block_tridiag solves T X = R for a symmetric positive definite
block-tridiagonal T: A (n, b, b) its diagonal blocks, O (n-1, b, b) its
sub-diagonal blocks (O_i = T[i+1, i]), R (n, b, m). It keeps the SPIKE
split of models/pose_graph.block_tridiag_solve: a chain of more than 2q
blocks is cut into ceil(n/q) segments of q (the last one padded with
identity blocks); each segment's q-1 interior blocks are solved by block
Thomas against the panel [R | E_f | E_l] (the two spikes); the segments'
last blocks form a reduced block-tridiagonal interface system, solved by
one more Thomas; the interior solutions follow from the interface's. A
chain of at most 2q blocks is one segment of n blocks, whose n-1 interior
blocks and one interface block make plain block Thomas. Each diagonal
block is inverted by Gauss-Jordan elimination without pivoting (every
pivot of an SPD block is a positive Schur complement, the pivot a Cholesky
factorization would take), and the arithmetic is float64 whatever the
inputs' dtype.

For CUDA tensors the wrapper launches the kernel's three launches on the
current stream, with no host read; for CPU tensors it runs the kernel's
plain version, block_tridiag_solve_plain, which repeats the kernel's
arithmetic in PyTorch. There is no fallback from a CUDA tensor to the plain
version: a launch failure raises. No path of the port runs the plain
version: models/pose_graph sends CPU tensors to its op-by-op solve, which
the JAX parity tests hold.
"""

from __future__ import annotations

import functools

import torch

from . import build

MAX_B = 32  # widest block: a 32 x 32 shared-memory tile
LAUNCHES = 3  # a solve: the segments, the interface, the interiors
_F64 = torch.float64


def segments(n: int, q: int) -> tuple[int, int]:
    """(q_eff, B): the length and number of the SPIKE segments of a chain
    of n blocks; a chain of at most 2q blocks is one segment of n."""
    if n <= 2 * q:
        return n, 1
    if q < 2:
        raise ValueError(f"the SPIKE split needs q >= 2, got q = {q}")
    return q, -(-n // q)


def block_tridiag(A: torch.Tensor, O: torch.Tensor, R: torch.Tensor,
                  q: int = 64) -> torch.Tensor:
    """X (n, b, m) with T X = R, in R's dtype; see the module docstring.

    A (n, b, b), O (n-1, b, b), R (n, b, m): float32 or float64, one dtype,
    contiguous on one device, 1 <= b <= MAX_B.
    """
    if not A.is_cuda:
        return block_tridiag_solve_plain(A, O, R, q)
    if A.dim() != 3 or A.shape[1] != A.shape[2] or R.dim() != 3:
        raise ValueError(f"A must be (n, b, b) and R (n, b, m), got "
                         f"{tuple(A.shape)} and {tuple(R.shape)}")
    n, b, m = A.shape[0], A.shape[1], R.shape[2]
    if not (n >= 1 and 1 <= b <= MAX_B and m >= 1):
        raise ValueError(f"need n >= 1, 1 <= b <= {MAX_B} and m >= 1, got "
                         f"n = {n}, b = {b}, m = {m}")
    if A.dtype not in (torch.float32, _F64):
        raise ValueError(f"A must be float32 or float64, got {A.dtype}")
    index = A.get_device()
    for name, t, shape in (("A", A, (n, b, b)), ("O", O, (n - 1, b, b)),
                           ("R", R, (n, b, m))):
        if t.shape != shape or t.dtype is not A.dtype:
            raise ValueError(f"{name} must be {shape} {A.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {A.device}")
    qs, _ = segments(n, q)
    doubles = _scratch_doubles(n, b, m, qs)
    scratch = torch.empty(doubles, dtype=_F64, device=A.device)
    X = torch.empty_like(R)
    _BLOCK_TRIDIAG(index, A.data_ptr(), O.data_ptr(), R.data_ptr(),
                   X.data_ptr(), scratch.data_ptr(), doubles, n, b, m, qs,
                   int(A.dtype is _F64))
    block_tridiag.launches += LAUNCHES
    return X


@functools.lru_cache(maxsize=64)
def _scratch_doubles(n: int, b: int, m: int, q: int) -> int:
    """float64 scratch entries of the kernel at this shape (the C
    layout)."""
    return build.library().slam_block_tridiag_scratch(n, b, m, q)


_BLOCK_TRIDIAG = build.Entry("slam_block_tridiag")
block_tridiag.launches = 0


def _gj_inverse(D: torch.Tensor) -> torch.Tensor:
    """Inverse of each SPD block of D (..., b, b) by Gauss-Jordan
    elimination without pivoting, as the kernel runs it: step k scales row
    k by 1 / d_kk, subtracts d_ik times the scaled row from every other
    row, and writes -d_ik / d_kk into column k and 1 / d_kk on the
    diagonal. (The kernel takes 1 / d_kk to within an ulp by the hardware's
    reciprocal and two Newton steps.)"""
    a = D.clone()
    for k in range(a.shape[-1]):
        rp = 1.0 / a[..., k, k]
        row = a[..., k, :] * rp[..., None]
        col = a[..., :, k].clone()
        a -= col[..., :, None] * row[..., None, :]
        a[..., k, :] = row
        a[..., :, k] = -col * rp[..., None]
        a[..., k, k] = rp
    return a


def _thomas_plain(A, O, P):
    """Block Thomas over the chain axis -3, batched over any leading axes:
    A (..., k, b, b), O (..., k-1, b, b), P (..., k, b, M). Forward: L_j =
    O_{j-1} G_{j-1}, G_j the inverse of A_j - L_j O_{j-1}^T, z_j = P_j -
    L_j z_{j-1}; backward: x_j = G_j z_j - L_{j+1}^T x_{j+1}."""
    T_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    G, L, z = [], [None], []
    for j in range(A.shape[-3]):
        if j == 0:
            D, zj = A[..., 0, :, :], P[..., 0, :, :]
        else:
            O_p = O[..., j - 1, :, :]
            L_j = O_p @ G[-1]
            D = A[..., j, :, :] - L_j @ T_(O_p)
            zj = P[..., j, :, :] - L_j @ z[-1]
            L.append(L_j)
        G.append(_gj_inverse(D))
        z.append(zj)
    x = [G[-1] @ z[-1]]
    for j in range(len(G) - 2, -1, -1):
        x.append(G[j] @ z[j] - T_(L[j + 1]) @ x[-1])
    return torch.stack(x[::-1], dim=-3)


def block_tridiag_solve_plain(A: torch.Tensor, O: torch.Tensor,
                              R: torch.Tensor, q: int = 64) -> torch.Tensor:
    """block_tridiag as the kernel computes it, on any device: float64
    inside, X in R's dtype."""
    n, b, m = A.shape[0], A.shape[-1], R.shape[-1]
    qs, B = segments(n, q)
    qi, n_pad, out = qs - 1, B * qs, R.dtype
    A, O, R = A.to(_F64), O.to(_F64), R.to(_F64)
    T_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    eye = torch.eye(b, dtype=_F64, device=A.device)
    # block g of the padded chain: identity diagonal, zero coupling and rhs
    A_p = torch.cat([A, eye.expand(n_pad - n, b, b)]).reshape(B, qs, b, b)
    O_p = torch.cat([O, O.new_zeros((n_pad - n + 1, b, b))]
                    ).reshape(B, qs, b, b)  # O_p[s, j] = T[g + 1, g]
    R_p = torch.cat([R, R.new_zeros((n_pad - n, b, m))]).reshape(B, qs, b, m)
    zbb = A.new_zeros((1, b, b))
    if qi:
        # (a) each segment's interior against [R | E_f | E_l]
        E = A.new_zeros((B, qi, b, 2 * b))
        E[:, 0, :, :b] = eye
        E[:, qi - 1, :, b:] = eye
        Y = _thomas_plain(A_p[:, :qi], O_p[:, :qi - 1],
                          torch.cat([R_p[:, :qi], E], dim=-1))
        YR, Yf, Yl = Y[..., :m], Y[..., m:m + b], Y[..., m + b:]
        Rc = O_p[:, qi - 1]  # the last interior block to the interface
        Lc = torch.cat([zbb, O_p[:-1, qs - 1]])  # the last interface in
        own_A = A_p[:, qi] - Rc @ (Yl[:, qi - 1] @ T_(Rc))
        own_R = R_p[:, qi] - Rc @ YR[:, qi - 1]
        left_A = -(T_(Lc) @ (Yf[:, 0] @ Lc))
        left_R = -(T_(Lc) @ YR[:, 0])
        left_O = -(Rc @ (Yf[:, qi - 1] @ Lc))
    else:
        own_A, own_R = A_p[:, 0], R_p[:, 0]
        left_A, left_R, left_O = (torch.zeros_like(own_A),
                                  torch.zeros_like(own_R),
                                  torch.zeros_like(own_A))
    # (b) the interface system
    A_hat = own_A + torch.cat([left_A[1:], zbb])
    R_hat = own_R + torch.cat([left_R[1:], R.new_zeros((1, b, m))])
    x_hat = _thomas_plain(A_hat, left_O[1:], R_hat)
    if not qi:
        return x_hat.to(out)
    # (c) the interiors from the interfaces on either side
    x_left = torch.cat([R.new_zeros((1, b, m)), x_hat[:-1]])
    u, v = Lc @ x_left, T_(Rc) @ x_hat
    x_int = YR - Yf @ u[:, None] - Yl @ v[:, None]
    X = torch.cat([x_int, x_hat[:, None]], dim=1).reshape(n_pad, b, m)
    return X[:n].to(out)
