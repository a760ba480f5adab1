"""Sharded execution of the SLAM hot paths over a rank mesh.

Counterpart of lidar_slam_tpu/parallel/sharding.py, with its names and
signatures plus the mesh (parallel/mesh.Mesh). Each returned function is
the program of one rank: it takes the whole (replicated) inputs, slices
its shard, runs the port's single-device function on it and combines
through mesh.psum, pmax and all_gather; every rank returns the same
whole result. Inputs whose sharded axis is not a multiple of the axis
size raise (pad them: pad_batch).

  - ICP pairs shard over "dp" (sharded_icp_batch). The JAX package
    all-reduces any(~done) in every iteration of its sharded while_loop;
    here each rank runs ops/icp.run_icp_batch on its pair block to the
    block's own convergence and one all_gather follows. The loop freezes
    a pair once it is done, so a pair's iterations and correspondences do
    not depend on when the other pairs stop, and its T and error differ
    from JAX's (and the single-device run's) only by the float
    reassociation of a block's batch shape.
  - Map building shards RAYS (sharded_build_logodds: one psum of a (W, H)
    delta a scan, then the clip) or SCANS (sharded_build_logodds_scans:
    each rank composes its contiguous block through ops/clamp_affine, one
    all_gather of (a, lo, hi), compose_tree in scan order). The per-scan
    delta is ops/raywalk.scan_delta_raywalk: K2 (raywalk_scan, no clip)
    on CUDA tensors, its plain version, occupancy.scatter_scan_ on a zero
    grid, on CPU tensors.
  - Texture frames (sharded_texture_paint) and paint-op streams
    (sharded_paint_ops): a local scatter-max of global sequence numbers,
    then pmax of the winner and psum of the one selected colour. Exact.
  - Relocalization nodes (sharded_reloc_score) and particles
    (sharded_pf_score): per-node and per-particle row sums on a block,
    gathered; bit-equal to the single-device scorers.
  - Pose-graph factors (sharded_optimize_trajectory ->
    models/pose_graph.optimize_sharded): one fused psum an LM iteration.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MapConfig
from ..models.occupancy import check_backend
from ..ops.icp import IcpResult, run_icp_batch
from ..ops.raywalk import scan_delta_raywalk
from .mesh import Mesh, all_gather, pmax, psum, shard_slice


def sharded_icp_batch(mesh: Mesh, axis: str = "dp"):
    """Return run_icp_batch with its pair batch sharded over `axis`:
    fn(src, tgt, src_mask, tgt_mask, init_T, **kw) -> IcpResult of the
    whole batch. Pad the batch to a multiple of the axis size first.

    One all_gather of every rank's (T, error, iterations, correspondences),
    packed in T's dtype (iteration counts and indices are integers below
    2^24, exact in float32)."""

    def fn(src, tgt, src_mask, tgt_mask, init_T, **kw):
        B, P = src.shape[:2]
        if P >= 1 << 24:
            raise ValueError(f"{P} points a cloud: correspondences must "
                             "stay below 2^24 to pack in float32")
        sl = shard_slice(B, mesh, axis, "ICP pairs")
        res = run_icp_batch(src[sl], tgt[sl], src_mask[sl], tgt_mask[sl],
                            init_T[sl], **kw)
        dt = res.T.dtype
        b = res.T.shape[0]
        packed = torch.cat([res.T.reshape(b, 16), res.error[:, None].to(dt),
                            res.iters[:, None].to(dt),
                            res.correspondences.to(dt)], dim=1)
        whole = all_gather(packed, mesh, axis).reshape(B, 18 + P)
        return IcpResult(T=whole[:, :16].reshape(B, 4, 4),
                         error=whole[:, 16].to(res.error.dtype),
                         iters=whole[:, 17].to(torch.int32),
                         correspondences=whole[:, 18:].to(torch.int32))

    return fn


def sharded_build_logodds(mesh: Mesh, cfg: MapConfig, K: int,
                          axis: str = "dp", backend: str = "auto"):
    """Return a map builder sharding RAYS over `axis`:
    build(poses (N, 3), points (N, R, 2), masks (N, R), init=None) ->
    (W, H) float32. R must be a multiple of the axis size (pad rays with
    mask=False). Each rank walks its ray block of every scan into an
    unclipped delta, one psum a scan sums the deltas, and the carried grid
    takes the reference's per-scan clip (modules/ogm.py:149-188): within a
    scan contributions are a pure sum, so this is the sequential build up
    to float reassociation of each scan's adds."""

    def build(poses, points, masks, init=None):
        check_backend(backend, points)
        sl = shard_slice(points.shape[1], mesh, axis, "rays")
        c = cfg.logodds_clip
        grid = (torch.zeros((cfg.width, cfg.height), dtype=torch.float32,
                            device=points.device)
                if init is None else init.to(torch.float32))
        for s in range(points.shape[0]):
            delta = scan_delta_raywalk(poses[s], points[s, sl],
                                       masks[s, sl].contiguous(), cfg, K)
            grid = torch.clamp(grid + psum(delta, mesh, axis), -c, c)
        return grid

    return build


def sharded_build_logodds_scans(mesh: Mesh, cfg: MapConfig, K: int,
                                axis: str = "dp", backend: str = "auto"):
    """Return a map builder sharding SCANS over `axis`:
    build(poses (N, 3), points (N, R, 2), masks (N, R), init=None) ->
    (W, H) float32. N must be a multiple of the axis size: pad with
    all-masked scans, whose update is the identity.

    The clipped per-scan update is a clamp-affine function of the carried
    grid, and those compose associatively (ops/clamp_affine.py): each rank
    walks its contiguous block of N/D scans composing (a, lo, hi); one
    all_gather brings every block's triple; compose_tree merges them in
    scan order and the result applies to init (zeros by default). Each
    rank walks N/D scans and the layer makes one collective, against the
    ray split's N. Equal to the sequential build up to float
    reassociation (each scan's delta is summed apart from the carried
    grid), and a few ULPs of the rail at saturated cells."""
    from ..ops import clamp_affine as ca

    def build(poses, points, masks, init=None):
        check_backend(backend, points)
        sl = shard_slice(points.shape[0], mesh, axis, "scans")
        c = cfg.logodds_clip
        shape = (cfg.width, cfg.height)
        f = ca.identity(shape, c, device=points.device)
        for s in range(sl.start, sl.stop):
            delta = scan_delta_raywalk(poses[s], points[s],
                                       masks[s].contiguous(), cfg, K)
            f = ca.update(f, delta, c)
        fs = all_gather(torch.stack(f), mesh, axis)
        total = ca.compose_tree([ca.ClampAffine(*blk) for blk in fs])
        v0 = (torch.zeros(shape, dtype=torch.float32, device=points.device)
              if init is None else init.to(torch.float32))
        return ca.apply(total, v0)

    return build


def _combine_paint(winner, cell_color, local_w, local_c, mesh: Mesh,
                   axis: str):
    """Cross-rank last-writer-wins: sequence numbers are unique, so
    exactly one rank holds each painted cell's pmax."""
    wmax = pmax(local_w, mesh, axis)
    sel = (local_w == wmax) & (wmax >= 0)
    cmax = psum(torch.where(sel, local_c, torch.zeros_like(local_c)), mesh,
                axis)
    winner_new = torch.maximum(winner, wmax)
    return winner_new, torch.where(winner_new > winner, cmax, cell_color)


def _local_paint(lin, colors, base_l: int, ncells: int):
    """One rank's scatter-max of its points' sequence numbers
    (base_l + index; -1 for invalid points) and each won cell's colour."""
    n = lin.shape[0]
    hit = lin >= 0
    seq = torch.arange(base_l, base_l + n, dtype=torch.int32,
                       device=lin.device)
    upd = torch.where(hit, seq, -1)
    safe = torch.where(hit, lin, 0).long()
    local_w = torch.full((ncells,), -1, dtype=torch.int32,
                         device=lin.device).scatter_reduce(0, safe, upd,
                                                           "amax")
    local_c = torch.where(
        local_w >= 0, colors[(local_w - base_l).clamp(0, n - 1).long()],
        torch.zeros_like(local_w))
    return local_w, local_c


def sharded_texture_paint(mesh: Mesh, map_cfg: MapConfig, cam_cfg,
                          axis: str = "dp"):
    """Return a texture painter sharding FRAMES over `axis`:
    paint(winner, cell_color, disp, rgb, poses, frame_mask, base) ->
    (winner, cell_color). winner/cell_color (W*H,) int32 carries (start
    -1 / 0); disp (B, H, W), rgb (B, H, W, 3) uint8, poses (B, 3),
    frame_mask (B,) bool (False: a padding frame, paints nothing); B a
    multiple of the axis size; base the global point index of frame 0
    (frame-major, B*H*W a batch). Each rank runs texture.frames_to_cells on
    its frames, its points numbered from base + rank * b_local * H * W.
    Bit-equal to the sequential texture.paint_cells."""
    from ..models.texture import frames_to_cells

    ncells = map_cfg.width * map_cfg.height

    def paint(winner, cell_color, disp, rgb, poses, frame_mask, base):
        sl = shard_slice(disp.shape[0], mesh, axis, "frames")
        hw = disp.shape[1] * disp.shape[2]
        lin, colors, _ = frames_to_cells(disp[sl], rgb[sl], poses[sl],
                                         map_cfg, cam_cfg)
        fm = frame_mask[sl].repeat_interleave(hw)
        lin = torch.where(fm, lin, -1)
        local_w, local_c = _local_paint(lin, colors, int(base) + sl.start * hw,
                                        ncells)
        return _combine_paint(winner, cell_color, local_w, local_c, mesh,
                              axis)

    return paint


def sharded_paint_ops(mesh: Mesh, map_cfg: MapConfig, axis: str = "dp"):
    """Return a painter sharding a PAINT-OP stream over `axis`:
    paint(winner, cell_color, ops, base) -> (winner, cell_color). ops
    (2, PAD) int32 from texture._pad_paint_ops (row 0 cells, -1 padding;
    row 1 colours; frame order, so later ops win); PAD must be a multiple
    of the axis size (raises); base the global sequence number of op 0.
    Bit-equal to texture.paint_ops."""
    ncells = map_cfg.width * map_cfg.height

    def paint(winner, cell_color, ops, base):
        sl = shard_slice(ops.shape[1], mesh, axis, "op stream length")
        local_w, local_c = _local_paint(ops[0, sl], ops[1, sl],
                                        int(base) + sl.start, ncells)
        return _combine_paint(winner, cell_color, local_w, local_c, mesh,
                              axis)

    return paint


def sharded_reloc_score(mesh: Mesh, axis: str = "dp"):
    """Return a node-sharded scorer for global relocalization, with the
    signature of relocalization._score_nodes (pool, base_i, base_j, rmask,
    ai, oi, oj, live, leaf=, chunk=) -> (n,) scores; pass it as score_fn
    to relocalization.relocalize. Nodes are padded (live=False) to a
    multiple of the axis size; each rank scores its block with the chunk
    min(chunk, block) and one all_gather replicates the (n,) scores.
    Node scores are row sums computed as on one device: the search (pose,
    score, certificate) is bit-equal."""
    from ..models.relocalization import _score_nodes

    def score(pool, base_i, base_j, rmask, ai, oi, oj, live, leaf, chunk):
        n = ai.shape[0]
        pad = (-n) % mesh.size(axis)
        ai_p, oi_p, oj_p = (pad_batch(v, mesh.size(axis))[0]
                            for v in (ai, oi, oj))
        live_p = pad_batch(live, mesh.size(axis), pad_value=False)[0]
        sl = shard_slice(n + pad, mesh, axis, "nodes")
        shard_chunk = min(chunk, max(1, (n + pad) // mesh.size(axis)))
        out = _score_nodes(pool, base_i, base_j, rmask, ai_p[sl], oi_p[sl],
                           oj_p[sl], live_p[sl], leaf=leaf,
                           chunk=shard_chunk)
        return all_gather(out, mesh, axis).reshape(-1)[:n]

    return score


def sharded_pf_score(mesh: Mesh, map_cfg: MapConfig, axis: str = "dp"):
    """Return a particle-sharded scorer for the particle filters, with the
    signature of particle_filter._score_particles minus map_cfg:
    (particles (P, 3), pts (R, 2), mask (R,), im (W, H)) -> (P,). P must be
    a multiple of the axis size. Each rank scores its particle block
    against the whole scan and map and one all_gather replicates the
    scores; everything else in the step stays replicated, so the sharded
    filter is bit-equal to the single-device one. Pass it as score_fn to
    pf_step, localize_particle_filter, pf_slam_step or
    slam_particle_filter."""
    from ..models.particle_filter import _score_particles

    def score(particles, pts, mask, im):
        sl = shard_slice(particles.shape[0], mesh, axis, "particles")
        out = _score_particles(particles[sl], pts, mask, im, map_cfg)
        return all_gather(out, mesh, axis).reshape(-1)

    return score


def sharded_optimize_trajectory(mesh: Mesh, cfg=None, axis: str = "dp"):
    """Return a pose-graph optimizer sharding the FACTOR axis, with the
    signature of pose_graph.optimize_trajectory: run(poses0 (N, 3),
    relative_poses (N-1, 3, 3), loop_i, loop_j, loop_meas, loop_mask) ->
    LMResult (pose_graph.optimize_sharded has the design). Banded
    fixed-interval graphs only: a live loop wider than the band, or
    reversed, raises here before any work."""
    from ..config import PoseGraphConfig
    from ..models import pose_graph as pg

    if cfg is None:
        cfg = PoseGraphConfig()

    def run(poses0, relative_poses, loop_i, loop_j, loop_meas, loop_mask):
        band = cfg.fixed_interval
        pg._require_banded(loop_i, loop_j, loop_mask, band,
                           "sharded_optimize_trajectory")
        graph = pg.make_graph(relative_poses, cfg, loop_i=loop_i,
                              loop_j=loop_j, loop_meas=loop_meas,
                              loop_mask=loop_mask)
        return pg.optimize_sharded(
            poses0, graph, mesh, axis=axis, max_iters=cfg.max_lm_iters,
            lambda_init=cfg.lambda_init, lambda_up=cfg.lambda_up,
            lambda_down=cfg.lambda_down, cost_rtol=cfg.cost_rtol,
            band=band, robust=cfg.robust_loss,
            robust_delta=cfg.robust_delta)

    return run


def pad_batch(x: torch.Tensor, multiple: int, axis: int = 0,
              pad_value=0) -> Tuple[torch.Tensor, int]:
    """Pad `axis` up to a multiple; returns (padded, pad_count)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, 0
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, pad_value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis), pad
