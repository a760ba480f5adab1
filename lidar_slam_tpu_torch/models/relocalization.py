"""Global relocalization: multi-resolution correlative scan matching.

Counterpart of lidar_slam_tpu/models/relocalization.py. It solves the
kidnapped-robot problem: given an occupancy map and one scan, find the
pose with no prior better than "somewhere in this window". Branch-and-bound
over a max-pooled map pyramid (Olson 2009) is restructured as a BATCHED
coarse-to-fine beam with a post-hoc exactness certificate:

  - pyramid level k holds the sliding-window max of the hit map over
    2^k x 2^k cells, so one gather-sum at level k upper-bounds the score
    of every leaf pose in the node's translation block;
  - every level scores all its nodes in fixed-size chunks of one
    gather-sum over the subsampled scan and keeps the top `beam` (a stable
    descending sort: node scores are integer sums and tie constantly, and
    the sort keeps the lower index first, as jax.lax.top_k does);
  - the best bound the beam dropped is recorded per level, and the leaf
    returned is provably the optimum over the sampled pose grid iff no
    dropped bound exceeds its score (`certified`, `pruned_margin`).

The optional polish (relocalize_refined) runs one batched planar ICP
(ops/icp.run_icp_batch, its nearest neighbours by the nn_argmin kernel on
CUDA tensors) from the top candidates against the occupied-cell centres.
top_candidates and occupied_points are host numpy, as in the JAX package
(relocalization is a rare event, not a per-step path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import MapConfig
from ..ops import icp as icp_ops
from ..utils import se2
from ..utils.precision import in_float64
from . import occupancy


@dataclass(frozen=True)
class RelocConfig:
    """Global-relocalization search parameters (new surface).

    The pose grid searched is `n_angles` yaw samples spanning `yaw_span`
    around `yaw_center`, times every grid cell within `search_radius`
    meters of the search center. `n_levels` sets the coarsest translation
    block (2^(n_levels-1) cells); `beam` is the node budget carried
    between levels; `max_rays` subsamples the scan with a static stride.
    """

    n_angles: int = 360
    yaw_center: float = 0.0
    yaw_span: float = 2.0 * np.pi
    search_radius: float = 10.0
    n_levels: int = 5
    beam: int = 1024
    max_rays: int = 256
    score_chunk: int = 16384  # nodes scored per chunk (memory bound)
    # ICP-polish target window: occupied cells within (max masked scan
    # range + icp_margin) of the grid candidate
    icp_margin: float = 5.0


class RelocResult(NamedTuple):
    pose: torch.Tensor           # (3,) best grid pose (cell/angle resolution)
    score: torch.Tensor          # () true hit count of the best leaf
    certified: torch.Tensor      # () bool: provably optimal over the grid
    pruned_margin: torch.Tensor  # () score - max dropped bound


def hit_map(logodds: torch.Tensor) -> torch.Tensor:
    """1.0 where the log-odds grid says obstacle, 0.0 elsewhere."""
    return (logodds > 0).to(torch.float32)


def build_max_pyramid(im: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Sliding-window max pyramid: pool[k][i, j] = max(im[i:i+2^k,
    j:j+2^k]) with out-of-range cells 0, built in k doubling passes of
    three shifted maxima. im is clamped at 0, so the zero padding stays an
    upper bound."""
    im = torch.clamp(im, min=0.0)
    levels = [im]
    m = im
    for k in range(n_levels - 1):
        s = 1 << k
        mi = torch.nn.functional.pad(m, (0, 0, 0, s))[s:, :]
        mj = torch.nn.functional.pad(m, (0, s, 0, 0))[:, s:]
        mij = torch.nn.functional.pad(m, (0, s, 0, s))[s:, s:]
        m = torch.maximum(torch.maximum(m, mi), torch.maximum(mj, mij))
        levels.append(m)
    return levels


def _score_nodes(pool: torch.Tensor, base_i: torch.Tensor,
                 base_j: torch.Tensor, rmask: torch.Tensor, ai: torch.Tensor,
                 oi: torch.Tensor, oj: torch.Tensor, live: torch.Tensor,
                 leaf: bool, chunk: int) -> torch.Tensor:
    """Score a node list against one pyramid level.

    pool (W, H) level map; base_i/base_j (A, R) endpoint cells of the
    subsampled scan at the search center for each yaw sample; rmask (R,)
    ray validity; ai/oi/oj (n,) node (angle, cell-offset) coordinates; live
    (n,) False for dead nodes (scored -inf). Nodes are scored `chunk` at a
    time, so memory is O(chunk * R).

    Non-leaf levels gather with CLIPPED indices and no bounds mask: the
    clipped pooled value still upper-bounds every in-bounds leaf below an
    out-of-window anchor. The leaf level applies the true out-of-bounds
    mask, so its score is the exact hit count.
    """
    W, H = pool.shape
    n = ai.shape[0]
    scores = torch.empty(n, dtype=pool.dtype, device=pool.device)
    for lo in range(0, n, chunk):
        a = ai[lo:lo + chunk].long()
        gi = base_i[a] + oi[lo:lo + chunk, None]   # (chunk, R)
        gj = base_j[a] + oj[lo:lo + chunk, None]
        vals = pool[gi.clamp(0, W - 1).long(), gj.clamp(0, H - 1).long()]
        ok = rmask[None, :]
        if leaf:
            ok = ok & (gi >= 0) & (gi < W) & (gj >= 0) & (gj < H)
        scores[lo:lo + chunk] = torch.where(ok, vals,
                                            torch.zeros_like(vals)).sum(1)
    return torch.where(live, scores, torch.full_like(scores, -np.inf))


def _keep_top(scores: torch.Tensor, ai, oi, oj, k: int):
    """Beam select: the top-k nodes plus the best DROPPED score (the
    certificate input; -inf when nothing is dropped). Ties keep the lower
    index first (a stable descending sort), as jax.lax.top_k does."""
    n = scores.shape[0]
    if n <= k:
        return scores, ai, oi, oj, torch.tensor(-np.inf, dtype=scores.dtype,
                                                device=scores.device)
    top, idx = torch.sort(scores, descending=True, stable=True)
    keep = idx[:k]
    return top[:k], ai[keep], oi[keep], oj[keep], top[k]


def _angles(cfg: RelocConfig) -> np.ndarray:
    """The search's yaw samples (float64, as the JAX package's)."""
    return (cfg.yaw_center - cfg.yaw_span / 2.0
            + cfg.yaw_span * np.arange(cfg.n_angles) / cfg.n_angles)


def _base_cells(pts: torch.Tensor, mask: torch.Tensor, center: torch.Tensor,
                angles: np.ndarray, map_cfg: MapConfig, max_rays: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Endpoint cells of the (stride-subsampled) scan for every yaw sample,
    translated to the search center. Returns (A, R') i/j cells + (R',)
    mask."""
    R = pts.shape[0]
    stride = max(1, -(-R // max_rays))
    p = pts[::stride]
    m = mask[::stride]
    # cos and sin rounded once from float64, so the card's cells equal the
    # CPU's
    th = torch.as_tensor(angles, dtype=torch.float32, device=pts.device)
    c, s = (in_float64(f, th)[:, None] for f in (torch.cos, torch.sin))
    xw = c * p[None, :, 0] - s * p[None, :, 1] + center[0]
    yw = s * p[None, :, 0] + c * p[None, :, 1] + center[1]
    gi, gj = occupancy.world2grid(xw, yw, map_cfg)
    return gi, gj, m


def relocalize(im: torch.Tensor, map_cfg: MapConfig, pts: torch.Tensor,
               mask: torch.Tensor, cfg: RelocConfig = RelocConfig(),
               center: Tuple[float, float] = (0.0, 0.0),
               score_fn=None, return_leaves: bool = False):
    """Find the scan's pose in the map by certified coarse-to-fine search,
    on im's device.

    im (W, H) non-negative scoring map (hit_map(logodds)); pts (R, 2)
    robot-frame points; mask (R,); center: search window center in world
    meters. score_fn overrides the node scorer (_score_nodes' signature),
    the hook a node-sharded scorer plugs into (JAX:
    parallel/sharding.sharded_reloc_score). With return_leaves, also
    returns the leaf level's (scores, ai, oi, oj).
    """
    ctr = torch.tensor(center, dtype=torch.float32, device=im.device)
    base = _base_cells(pts, mask, ctr, _angles(cfg), map_cfg, cfg.max_rays)
    return search(im, map_cfg, base, cfg, center, score_fn, return_leaves)


def search(im: torch.Tensor, map_cfg: MapConfig, base, cfg: RelocConfig,
           center: Tuple[float, float], score_fn=None,
           return_leaves: bool = False):
    """relocalize() from given base cells (_base_cells' (base_i, base_j,
    rmask)): the level loop, the certificate and the best leaf's pose. A
    caller holding two devices' base cells can run one search on both."""
    score_nodes = _score_nodes if score_fn is None else score_fn
    dev = im.device
    base_i, base_j, rmask = base
    pyramid = build_max_pyramid(im, cfg.n_levels)

    S = int(np.ceil(cfg.search_radius / map_cfg.resolution))
    kmax = cfg.n_levels - 1
    block = 1 << kmax
    T = -((-(2 * S + 1)) // block)
    us = np.arange(T, dtype=np.int32) * block - S
    a0, u0, v0 = np.meshgrid(np.arange(cfg.n_angles, dtype=np.int32), us, us,
                             indexing="ij")
    ai, oi, oj = (torch.as_tensor(a.ravel(), device=dev)
                  for a in (a0, u0, v0))
    live = torch.ones(ai.shape, dtype=torch.bool, device=dev)

    pruned = []
    for k in range(kmax, -1, -1):
        scores = score_nodes(pyramid[k], base_i, base_j, rmask, ai, oi, oj,
                             live, leaf=(k == 0), chunk=cfg.score_chunk)
        if k == 0:
            break
        scores, ai, oi, oj, pmax = _keep_top(scores, ai, oi, oj, cfg.beam)
        pruned.append(pmax)
        s = 1 << (k - 1)
        n = ai.shape[0]
        ai = ai.repeat(4)
        di = torch.tensor([0, s, 0, s], dtype=torch.int32, device=dev)
        dj = torch.tensor([0, 0, s, s], dtype=torch.int32, device=dev)
        oi = oi.repeat(4) + di.repeat_interleave(n)
        oj = oj.repeat(4) + dj.repeat_interleave(n)
        # the block tiling rounds the window up to a multiple of the
        # coarsest block: leaves can sit up to one block past the radius
        live = torch.isfinite(scores).repeat(4)

    best = torch.argmax(scores)
    s_star = scores[best]
    res = torch.tensor(map_cfg.resolution, dtype=torch.float32, device=dev)
    ctr = torch.tensor(center, dtype=torch.float32, device=dev)
    angles = torch.as_tensor(_angles(cfg), dtype=torch.float32, device=dev)
    pose = torch.stack([ctr[0] + oi[best].to(torch.float32) * res,
                        ctr[1] + oj[best].to(torch.float32) * res,
                        angles[ai[best].long()]])
    pruned_max = (torch.stack(pruned).max() if pruned
                  else torch.tensor(-np.inf, device=dev))
    result = RelocResult(pose=pose, score=s_star,
                         certified=pruned_max <= s_star,
                         pruned_margin=s_star - pruned_max)
    if not return_leaves:
        return result
    return result, (scores, ai, oi, oj)


def top_candidates(leaves, angles: np.ndarray, center, map_cfg: MapConfig,
                   n_best: int, nms_radius: float = 1.0,
                   nms_yaw: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct pose hypotheses from the leaf-level node list: greedy
    score-ranked non-max suppression over (translation, yaw); two nodes
    are duplicates when their distance is under `nms_radius` meters AND
    their yaw gap under `nms_yaw` rad. Host numpy, as the JAX package's.
    Returns (poses (k, 3), scores (k,)) with k <= n_best."""
    scores, ai, oi, oj = (x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else np.asarray(x)
                          for x in leaves)
    res = map_cfg.resolution
    order = np.argsort(-scores)
    order = order[np.isfinite(scores[order])]
    kept: list[int] = []
    yaws = np.asarray(angles)
    for idx in order:
        x = center[0] + oi[idx] * res
        y = center[1] + oj[idx] * res
        th = yaws[ai[idx]]
        dup = False
        for j in kept:
            dx = x - (center[0] + oi[j] * res)
            dy = y - (center[1] + oj[j] * res)
            dth = abs((th - yaws[ai[j]] + np.pi) % (2 * np.pi) - np.pi)
            if dx * dx + dy * dy < nms_radius ** 2 and dth < nms_yaw:
                dup = True
                break
        if not dup:
            kept.append(int(idx))
            if len(kept) >= n_best:
                break
    poses = np.stack([
        np.asarray([center[0] + oi[j] * res, center[1] + oj[j] * res,
                    yaws[ai[j]]], np.float32) for j in kept])
    return poses, scores[kept]


def occupied_points(logodds, map_cfg: MapConfig, max_pts: int = 4096,
                    center: Tuple[float, float] | None = None,
                    radius: float | None = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied-cell CENTERS as a fixed-shape (max_pts, 2) cloud + mask,
    host numpy. world2grid maps cell i to world (i*res, (i+1)*res], so the
    center is at (i+0.5)*res. Evenly subsamples when more than max_pts
    cells qualify; pads with mask=False otherwise."""
    if isinstance(logodds, torch.Tensor):
        logodds = logodds.detach().cpu().numpy()
    lo = np.asarray(logodds)
    ii, jj = np.nonzero(lo > 0)
    x = (ii + 0.5) * map_cfg.resolution + map_cfg.world_min_x
    y = (jj + 0.5) * map_cfg.resolution + map_cfg.world_min_y
    if center is not None and radius is not None:
        keep = ((x - center[0]) ** 2 + (y - center[1]) ** 2) <= radius ** 2
        x, y = x[keep], y[keep]
    n = x.shape[0]
    if n > max_pts:
        sel = np.linspace(0, n - 1, max_pts).astype(np.int64)
        x, y = x[sel], y[sel]
        n = max_pts
    out = np.zeros((max_pts, 2), np.float32)
    out[:n, 0], out[:n, 1] = x, y
    m = np.zeros(max_pts, bool)
    m[:n] = True
    return out, m


def relocalize_refined(
    logodds: torch.Tensor, map_cfg: MapConfig, pts: torch.Tensor,
    mask: torch.Tensor, cfg: RelocConfig = RelocConfig(),
    center: Tuple[float, float] = (0.0, 0.0),
    icp_max_iters: int = 100, icp_max_pts: int = 4096,
    score_fn=None, n_candidates: int = 1,
) -> Tuple[RelocResult, torch.Tensor, torch.Tensor]:
    """Grid search + ICP polish on logodds' device: returns (grid result,
    refined pose (3,), icp error).

    The polish runs planar ICP from the candidate(s) against the
    occupied-cell centers near each (ops/icp, normalized error). With
    n_candidates > 1 the top NMS'd candidates by grid score
    (top_candidates) are polished in ONE batched ICP call and the lowest
    normalized ICP error wins: correlative hit counts alias in
    self-similar rooms, and the geometric fit separates the true pose from
    such aliases. The returned grid result still describes the
    score-ranked best (its certificate is about the grid score).
    """
    dev = logodds.device
    grid_res, leaves = relocalize(hit_map(logodds), map_cfg, pts, mask, cfg,
                                  center, score_fn=score_fn,
                                  return_leaves=True)
    if n_candidates > 1:
        cand, _ = top_candidates(leaves, _angles(cfg), center, map_cfg,
                                 n_candidates)
    else:
        cand = grid_res.pose.detach().cpu().numpy().astype(np.float32)[None]
    src, tgt, src_m, tgt_m = polish_inputs(logodds, map_cfg, pts, mask,
                                           cand, cfg, icp_max_pts)
    B = cand.shape[0]
    res = icp_ops.run_icp_batch(
        src, tgt, src_m, tgt_m,
        torch.eye(4, dtype=src.dtype, device=dev).expand(B, 4, 4),
        max_iters=icp_max_iters, normalize_error=True)
    best = int(torch.argmin(res.error))
    T2 = se2.TSE2_from_TSE3(res.T[best])
    cand_t = torch.as_tensor(cand, device=dev)
    refined = se2.pose_from_T(T2 @ se2.T_from_pose(cand_t[best]))
    return grid_res, refined, res.error[best]


def polish_inputs(logodds: torch.Tensor, map_cfg: MapConfig,
                  pts: torch.Tensor, mask: torch.Tensor, cand: np.ndarray,
                  cfg: RelocConfig = RelocConfig(), icp_max_pts: int = 4096
                  ) -> Tuple[torch.Tensor, ...]:
    """relocalize_refined's batched ICP inputs on logodds' device for the
    candidate poses cand (B, 3): the scan placed at each candidate, lifted
    to z = 0 (B, R, 3), the occupied-cell centers within the scan's reach
    plus cfg.icp_margin of each candidate (B, icp_max_pts, 3), and both
    masks. The ICP starts from the identity, so its first nearest-neighbour
    search runs on exactly these clouds."""
    dev = logodds.device
    B = cand.shape[0]
    # target window: every map cell the scan could touch from the
    # candidate, plus a drift margin
    scan_reach = float(torch.max(torch.where(
        mask, torch.linalg.vector_norm(pts, dim=-1),
        torch.zeros((), dtype=pts.dtype, device=dev))))
    lo_np = logodds.detach().cpu().numpy()
    tgts = np.zeros((B, icp_max_pts, 2), np.float32)
    tgt_ms = np.zeros((B, icp_max_pts), bool)
    for b in range(B):
        tgts[b], tgt_ms[b] = occupied_points(
            lo_np, map_cfg, max_pts=icp_max_pts,
            center=(float(cand[b, 0]), float(cand[b, 1])),
            radius=scan_reach + cfg.icp_margin)
    cand_t = torch.as_tensor(cand, device=dev)
    src_w = se2.transform_points(pts[None], se2.T_from_pose(cand_t))
    return (icp_ops.lift_to_3d(src_w).contiguous(),
            icp_ops.lift_to_3d(torch.as_tensor(tgts, device=dev)).contiguous(),
            mask.expand(B, -1), torch.as_tensor(tgt_ms, device=dev))
