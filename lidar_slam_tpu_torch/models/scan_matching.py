"""Scan matching: ICP-refined odometry over all consecutive scan pairs.

Counterpart of lidar_slam_tpu/models/scan_matching.py. Each pair's ICP is
seeded from the ODOMETRY relative pose, not from the refined chain, so all
pairs are independent: the stage is one batched ICP over every
consecutive pair, processed in fixed-size chunks, followed by a prefix
composition of the refined relative transforms.

Schedule: each chunk of pairs iterates until every pair in it is done (the
JAX package's "chunked" schedule). Its default "phased" re-sorting of live
pairs was a TPU batching device; it changes which pairs share a dispatch,
never a pair's iterates, so T, error and iteration count per pair are the
same under either schedule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import IcpConfig
from ..ops import icp as icp_ops
from ..utils import se2


class ScanMatchResult(NamedTuple):
    poses: torch.Tensor  # (N, 3) refined trajectory
    relative_poses: torch.Tensor  # (N-1, 3, 3) refined relative SE(2)
    errors: torch.Tensor  # (N-1,) final ICP errors
    iters: torch.Tensor  # (N-1,) ICP iterations per pair


def icp_all_pairs(
    src: torch.Tensor,
    tgt: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_mask: torch.Tensor,
    init_T: torch.Tensor,
    epsilon: float = 0.001,
    max_iters: int = 2000,
    stopping_thresh: float = 1e-4,
    normalize_error: bool = False,
    chunk_size: int = 64,
    trim_fraction: float = 1.0,
    metric: str = "point",
):
    """Batched planar ICP over B pairs in chunks of chunk_size.

    Inputs are padded to whole chunks; padding pairs get one valid target
    point and no valid source point, so their error is 0 < epsilon and they
    stop after one iteration. trim_fraction and metric pass through to
    ops/icp.run_icp_batch; a pair's result does not depend on the chunk it
    shares. Returns (T (B, 4, 4), errors (B,), iters (B,)).
    """
    B = src.shape[0]
    C = min(chunk_size, B)
    pad = -(-B // C) * C - B
    if pad:
        def pad0(x):
            return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        src, tgt = pad0(src), pad0(tgt)
        src_mask, tgt_mask = pad0(src_mask), pad0(tgt_mask)
        tgt_mask[B:, 0] = True
        eye = torch.eye(4, dtype=init_T.dtype, device=init_T.device)
        init_T = torch.cat([init_T, eye.expand(pad, 4, 4)])
    Ts, errs, its = [], [], []
    for c0 in range(0, B + pad, C):
        c1 = c0 + C
        res = icp_ops.run_icp_batch(
            src[c0:c1], tgt[c0:c1], src_mask[c0:c1], tgt_mask[c0:c1],
            init_T[c0:c1], epsilon=epsilon, max_iters=max_iters,
            stopping_thresh=stopping_thresh, normalize_error=normalize_error,
            trim_fraction=trim_fraction, metric=metric)
        Ts.append(res.T)
        errs.append(res.error)
        its.append(res.iters)
    return (torch.cat(Ts)[:B], torch.cat(errs)[:B], torch.cat(its)[:B])


def poses_from_scan_matching(
    x_ts: torch.Tensor,
    points: torch.Tensor,
    masks: torch.Tensor,
    cfg: IcpConfig = IcpConfig(),
    chunk_size: int = 64,
) -> ScanMatchResult:
    """Refine an odometry trajectory with batched consecutive-pair ICP.

    x_ts (N, 3) odometry poses; points (N, P, 2) robot-frame scan points;
    masks (N, P). Pair i aligns scan i+1 onto scan i, seeded with the
    odometry relative pose lifted to SE(3), under cfg.metric; the refined
    global poses are the prefix composition of the per-pair results,
    starting at the origin.
    """
    pts3 = icp_ops.lift_to_3d(points)
    seeds3 = se2.TSE3_from_TSE2(se2.get_relative_pose(x_ts[:-1], x_ts[1:]))
    T_icp, errors, iters = icp_all_pairs(
        pts3[1:], pts3[:-1], masks[1:], masks[:-1], seeds3,
        epsilon=cfg.epsilon, max_iters=cfg.max_iters,
        stopping_thresh=cfg.stopping_thresh,
        normalize_error=cfg.normalize_error, chunk_size=chunk_size,
        metric=cfg.metric)
    rel2 = se2.TSE2_from_TSE3(T_icp)
    poses = se2.pose_from_T(se2.compose_chain(rel2))
    return ScanMatchResult(poses=poses, relative_poses=rel2, errors=errors,
                           iters=iters)
