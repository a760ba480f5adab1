"""Batched masked ICP.

Counterpart of lidar_slam_tpu/ops/icp.py, with the
reference's stopping semantics (modules/icp.py:163-181): the transform is
composed BEFORE the break checks and the reported error is measured at the
pre-update transform, so the returned T is one fit ahead of the returned
error. A pair stops when (a) error < epsilon, (b) its iteration counter
reaches max_iters, or (c) |last_err - err| < stopping_thresh (skipped on
the first iteration); the point-to-line metric also stops when the error
matches the one two iterations back (a correspondence limit cycle). Pairs
in a batch iterate together; a pair that is done freezes while the others
continue.

Two options beyond the reference, as in the JAX package: trim_fraction < 1
runs trimmed ICP (TrICP: each iteration fits and measures only the best
fraction of valid points by correspondence distance), and
metric="point_to_line" runs PLICP (the fit and the error against the
matched target points' surface lines, ops/kabsch.py). Both keep the NN
kernel as the correspondence step; PLICP gathers the target normals by its
indices.

The fit is the closed-form planar Kabsch on z = 0 clouds (planar=True,
the whole SLAM pipeline) or the 3-D SVD Kabsch (planar=False, the ICP
warm-up of models/warmup.py); PLICP is planar only.

The JAX package runs the loop as one lax.while_loop on device; here it is a
Python loop that reads the batch's done flag after each iteration (the
"icp.batch" span; utils/tracing counts the trips as icp.sweeps). The
correspondence step is the Hopper NN kernel K4 for CUDA tensors
(kernels/nn.py) and its plain version for CPU tensors; nn_chunk bounds the
plain version's (B, N, M) distances on the CPU (ops/nn.py
nearest_neighbors_chunked, the JAX package's nn_backend="chunked").

Two paths, chosen from the inputs alone (fused_path): on CUDA float32
tensors, planar point-to-point ICP without trimming, the reference's
algorithm, runs each sweep as two launches, K4 and K5 (kernels/icp.py,
csrc/icp.cu), which fits, measures, applies the stopping rules and updates
the carry in place, the sources under the new transform included. PLICP,
TrICP, the 3-D fit and every CPU tensor take the op-by-op sweep, which is
also what K5 is held to on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.icp import icp_sweep_tail
from ..kernels.nn import nn_argmin
from ..utils import tracing
from .kabsch import (fit_point_to_line_planar, kabsch, kabsch_planar,
                     scan_normals_planar)
from .nn import gather_points, nearest_neighbors_chunked

_INF = float("inf")


class IcpResult(NamedTuple):
    T: torch.Tensor  # (B, 4, 4) final transforms
    error: torch.Tensor  # (B,) final (possibly normalized) error
    iters: torch.Tensor  # (B,) int32 iterations executed per pair
    correspondences: torch.Tensor  # (B, P) int32 final correspondences


def _transform(pts: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return (torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts)
            + T[..., None, :3, 3])


def _masked_minmax(pts: torch.Tensor, mask: torch.Tensor):
    m = mask[..., None]
    mn = torch.where(m, pts, torch.full_like(pts, _INF)).amin(dim=-2)
    mx = torch.where(m, pts, torch.full_like(pts, -_INF)).amax(dim=-2)
    return mn, mx


def _error(src_t, matched, mask, normalize: bool, d2=None):
    """Masked squared error; optionally normalized by the squared bbox
    diagonal of the transformed source AND the matched targets times the
    valid source count (reference modules/icp.py:76-98). d2 overrides the
    per-point squared residuals (the point-to-line metric)."""
    if d2 is None:
        d2 = torch.sum((src_t - matched) ** 2, dim=-1)
    err = torch.sum(torch.where(mask, d2, torch.zeros_like(d2)), dim=-1)
    if not normalize:
        return err
    mn1, mx1 = _masked_minmax(src_t, mask)
    mn2, mx2 = _masked_minmax(matched, mask)
    diag2 = torch.sum((torch.maximum(mx1, mx2) - torch.minimum(mn1, mn2)) ** 2,
                      dim=-1)
    n = torch.clamp(torch.sum(mask, dim=-1), min=1)
    return err / (diag2 * n)


def _trim_mask(d2: torch.Tensor, mask: torch.Tensor,
               trim_fraction: float) -> torch.Tensor:
    """Per pair, the mask cut to the best trim_fraction of VALID points by
    squared correspondence distance (TrICP's selection): k =
    clip(ceil(q n_valid), 1, max(n_valid, 1)) in d2's dtype, and every point
    at the k-th distance is kept, so ties can keep a few more than k.
    Invalid points sink to the end with an infinite distance."""
    d2m = torch.where(mask, d2, torch.full_like(d2, _INF))
    order = torch.sort(d2m, dim=-1).values
    n_valid = torch.sum(mask, dim=-1)
    k = torch.ceil(trim_fraction * n_valid.to(d2.dtype)).long()
    k = torch.minimum(torch.clamp(k, min=1), torch.clamp(n_valid, min=1))
    thresh = torch.gather(order, -1, (k - 1)[..., None])
    return mask & (d2m <= thresh)


def fused_path(device: torch.device, dtype: torch.dtype, planar: bool,
               metric: str, trim_fraction: float) -> bool:
    """Whether run_icp_batch sweeps through K4 and K5 (the fused path)
    rather than op by op: CUDA float32 tensors, planar point-to-point ICP,
    no trimming."""
    return (device.type == "cuda" and dtype is torch.float32 and planar
            and metric == "point" and trim_fraction == 1.0)


def icp_iteration(src, tgt, src_mask, tgt_mask, T_prev,
                  normalize_error: bool = False, trim_fraction: float = 1.0,
                  metric: str = "point", planar: bool = True,
                  nn_chunk: int | None = None, *, carry=None, stop=None):
    """One batched ICP iteration on (B, P, 3) clouds.

    Returns (T_next, correspondences, error) with the error measured at
    T_prev. metric "point": the Kabsch fit (the reference), closed-form in
    the plane for z = 0 clouds (planar=True) or the 3-D SVD fit
    (planar=False); "point_to_line" (planar only): the PLICP fit and
    point-to-line error over the matches whose target normal is valid.
    trim_fraction < 1 fits and measures only the trimmed set (_trim_mask).
    nn_chunk: on CPU tensors, search the sources nn_chunk at a time (the
    same indices); CUDA tensors always take the NN kernel.

    With `carry`, the fused path's IcpCarry (src_t set), the sweep is K4 on
    carry.src_t and K5, and `stop` = (epsilon, max_iters, stopping_thresh)
    are _icp_body's stopping rules: the carry advances in place, done pairs
    frozen, and (carry.T, carry.idx, carry.err) is returned; T_prev is
    carry.T then.
    """
    if carry is not None:
        if not (metric == "point" and planar and trim_fraction == 1.0):
            raise ValueError("the fused sweep is planar point-to-point ICP "
                             "without trimming")
        idx, matched = nn_argmin(carry.src_t, tgt, tgt_mask)
        icp_sweep_tail(src, matched, idx, src_mask, carry, normalize_error,
                       *stop)
        return carry.T, carry.idx, carry.err
    if metric not in ("point", "point_to_line"):
        raise ValueError(f"unknown icp metric {metric!r}")
    if metric == "point_to_line" and not planar:
        raise ValueError("point_to_line ICP is planar only")
    src_t = _transform(src, T_prev)
    if nn_chunk and not src_t.is_cuda:
        idx = nearest_neighbors_chunked(src_t, tgt, tgt_mask, nn_chunk)
        matched = gather_points(tgt, idx)
    else:
        idx, matched = nn_argmin(src_t, tgt, tgt_mask)
    fit_mask = src_mask
    if trim_fraction < 1.0:
        d2 = torch.sum((src_t - matched) ** 2, dim=-1)
        fit_mask = _trim_mask(d2, src_mask, trim_fraction)
    if metric == "point_to_line":
        nrm, nvalid = scan_normals_planar(tgt[..., :2], tgt_mask)
        n_m = torch.gather(nrm, -2, idx.long()[..., None].expand(
            idx.shape + (2,)))
        w_pl = fit_mask & torch.gather(nvalid, -1, idx.long())
        T_fit = fit_point_to_line_planar(src_t[..., :2], matched[..., :2],
                                         n_m, w_pl)
        dpl2 = torch.sum(n_m * (src_t[..., :2] - matched[..., :2]),
                         dim=-1) ** 2
        err = _error(src_t, matched, w_pl, normalize_error, d2=dpl2)
    else:
        w = fit_mask.to(src.dtype)
        T_fit = (kabsch_planar(src_t[..., :2], matched[..., :2], w=w)
                 if planar else kabsch(src_t, matched, w=w))
        err = _error(src_t, matched, fit_mask, normalize_error)
    return T_fit @ T_prev, idx, err


class IcpCarry(NamedTuple):
    """Mid-run ICP state of a batch of pairs."""
    T: torch.Tensor  # (B, 4, 4)
    err: torch.Tensor  # (B,)
    last_err: torch.Tensor  # (B,)
    last_err2: torch.Tensor  # (B,) error two iterations back (cycle stop)
    idx: torch.Tensor  # (B, P) int32
    k: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    # (B, P, 3) the sources under T, K4's input: the fused path's carry only
    src_t: torch.Tensor | None = None


def initial_icp_carry(init_T: torch.Tensor, P: int, dtype: torch.dtype,
                      src: torch.Tensor | None = None) -> IcpCarry:
    """The carry before the first sweep. With src (B, P, 3), the fused
    path's carry: T a contiguous copy of init_T, which K5 updates in
    place, and src_t the sources under it."""
    B, dev = init_T.shape[0], init_T.device
    c = IcpCarry(
        T=init_T.to(dtype),
        err=torch.full((B,), _INF, dtype=dtype, device=dev),
        last_err=torch.full((B,), _INF, dtype=dtype, device=dev),
        last_err2=torch.full((B,), _INF, dtype=dtype, device=dev),
        idx=torch.zeros((B, P), dtype=torch.int32, device=dev),
        k=torch.zeros((B,), dtype=torch.int32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    if src is None:
        return c
    T = c.T.clone(memory_format=torch.contiguous_format)
    return c._replace(T=T, src_t=_transform(src, T).contiguous())


def _icp_body(src, tgt, src_mask, tgt_mask, c: IcpCarry, epsilon: float,
              max_iters: int, stopping_thresh: float,
              normalize_error: bool, trim_fraction: float = 1.0,
              metric: str = "point", planar: bool = True,
              nn_chunk: int | None = None) -> IcpCarry:
    """One iteration: live pairs advance one fit and evaluate the stopping
    rules with this iteration's error; done pairs freeze. A fused carry
    (src_t set) advances in place through K4 and K5."""
    if c.src_t is not None:
        icp_iteration(src, tgt, src_mask, tgt_mask, c.T, normalize_error,
                      trim_fraction, metric, planar, nn_chunk, carry=c,
                      stop=(epsilon, max_iters, stopping_thresh))
        return c
    T_new, idx, err = icp_iteration(src, tgt, src_mask, tgt_mask, c.T,
                                    normalize_error, trim_fraction, metric,
                                    planar, nn_chunk)
    live = ~c.done
    hit_eps = err < epsilon
    hit_iters = c.k >= max_iters
    first = torch.isinf(c.last_err)
    hit_delta = (~first) & (torch.abs(c.last_err - err) < stopping_thresh)
    if metric == "point_to_line":
        # the long point-to-line step falls into correspondence limit
        # cycles: also stop when the error matches the one two back
        hit_delta = hit_delta | (~torch.isinf(c.last_err2) & (
            torch.abs(c.last_err2 - err) < stopping_thresh))
    return IcpCarry(
        T=torch.where(live[:, None, None], T_new, c.T),
        err=torch.where(live, err, c.err),
        last_err=torch.where(live, err, c.last_err),
        last_err2=torch.where(live, c.last_err, c.last_err2),
        idx=torch.where(live[:, None], idx, c.idx),
        k=torch.where(live, c.k + 1, c.k),
        done=c.done | (live & (hit_eps | hit_iters | hit_delta)),
    )


def run_icp_batch(
    src: torch.Tensor,
    tgt: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_mask: torch.Tensor,
    init_T: torch.Tensor,
    epsilon: float = 0.01,
    max_iters: int = 2000,
    stopping_thresh: float = 1e-4,
    normalize_error: bool = False,
    trim_fraction: float = 1.0,
    metric: str = "point",
    planar: bool = True,
    nn_chunk: int | None = None,
) -> IcpResult:
    """Run ICP to convergence for a batch of pairs.

    src/tgt (B, P, 3) clouds (z = 0 for planar=True), src_mask/tgt_mask
    (B, P) validity, init_T (B, 4, 4) seeds. Defaults mirror the reference
    (modules/icp.py:123-133); trim_fraction, metric, planar and nn_chunk
    as icp_iteration. On the fused path (fused_path) each trip is two
    launches, K4 and K5.
    """
    fused = fused_path(src.device, src.dtype, planar, metric, trim_fraction)
    if fused:
        src, src_mask = src.contiguous(), src_mask.contiguous()
    c = initial_icp_carry(init_T, src.shape[1], src.dtype,
                          src if fused else None)
    # no pair starts done: the batch's done flag is read after each trip
    done = src.shape[0] == 0
    with tracing.span("icp.batch"):
        while not done:
            c = _icp_body(src, tgt, src_mask, tgt_mask, c, epsilon,
                          max_iters, stopping_thresh, normalize_error,
                          trim_fraction, metric, planar, nn_chunk)
            # a copy of B flags, no reduction kernel: a fused trip stays
            # two launches
            done = bool(c.done.cpu().all())
            tracing.count("icp.sweeps")
            tracing.count("host.syncs")
    return IcpResult(T=c.T, error=c.err, iters=c.k, correspondences=c.idx)


def lift_to_3d(pts: torch.Tensor) -> torch.Tensor:
    """Append z = 0 to 2-D points."""
    if pts.shape[-1] == 2:
        return torch.cat([pts, torch.zeros_like(pts[..., :1])], dim=-1)
    return pts


def run_icp(pc1, pc2, init_transform=None, epsilon: float = 0.01,
            max_iters: int = 2000, stopping_thresh: float = 1e-4,
            normalize_error: bool = False, pc1_mask=None, pc2_mask=None,
            planar: bool | None = None) -> IcpResult:
    """ICP of one pair, the reference's entry point (modules/icp.py:
    123-189): pc1 (N, D) onto pc2 (M, D) tensors, D 2 or 3. 2-D inputs are
    lifted to z = 0 and take the planar fit unless planar says otherwise.
    Returns the IcpResult of the pair, without the batch axis."""
    if planar is None:
        planar = pc1.shape[-1] == 2
    pc1, pc2 = lift_to_3d(pc1), lift_to_3d(pc2)
    if init_transform is None:
        init_transform = torch.eye(4, dtype=pc1.dtype, device=pc1.device)
    if pc1_mask is None:
        pc1_mask = torch.ones(pc1.shape[:-1], dtype=torch.bool,
                              device=pc1.device)
    if pc2_mask is None:
        pc2_mask = torch.ones(pc2.shape[:-1], dtype=torch.bool,
                              device=pc2.device)
    res = run_icp_batch(pc1[None], pc2[None], pc1_mask[None], pc2_mask[None],
                        init_transform[None], epsilon=epsilon,
                        max_iters=max_iters, stopping_thresh=stopping_thresh,
                        normalize_error=normalize_error, planar=planar)
    return IcpResult(*(a[0] for a in res))
