"""Scan-like ICP pairs for the tests of the fused ICP sweep (K5), on any
device: each target is a closed room's walls sampled by N rays' worth of
points with noise, each source the same walls sampled half a step along,
moved by a per-pair SE(2) offset whose size varies across the batch, so
pairs stop on different sweeps. No JAX: the card's tests import it."""

import numpy as np
import torch

from lidar_slam_tpu_torch.ops import icp as icp_ops


def _room(rng, n, phase, noise):
    k = rng.integers(5, 9)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = rng.uniform(4.0, 14.0, k)
    v = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    seg = np.roll(v, -1, 0) - v
    cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(seg, axis=1))])
    u = (np.arange(n) + phase) / n * cum[-1]
    j = np.clip(np.searchsorted(cum, u, side="right") - 1, 0, k - 1)
    f = ((u - cum[j]) / (cum[j + 1] - cum[j]))[:, None]
    return v[j] + f * seg[j] + rng.normal(0, noise, (n, 2))


def icp_pairs(B, N, M, seed, invalid=0.1, device="cpu"):
    """(src, tgt, src_mask, tgt_mask, init_T): (B, N, 3) and (B, M, 3)
    float32 z = 0 clouds, (B, N) and (B, M) bool masks with about
    `invalid` of each cloud masked, identity seeds (B, 4, 4)."""
    rng = np.random.default_rng(seed)
    src = np.zeros((B, N, 3), np.float32)
    tgt = np.zeros((B, M, 3), np.float32)
    for b in range(B):
        scale = 0.2 + 0.8 * b / max(B - 1, 1)
        yaw = rng.uniform(-0.08, 0.08) * scale
        trans = rng.uniform(-0.3, 0.3, 2) * scale
        state = rng.bit_generator.state
        t_pts = _room(rng, M, 0.0, 0.01)
        rng.bit_generator.state = state  # the same room for the source
        s_pts = _room(rng, N, 0.5, 0.01)
        c, s = np.cos(yaw), np.sin(yaw)
        src[b, :, :2] = s_pts @ np.array([[c, s], [-s, c]]) + trans
        tgt[b, :, :2] = t_pts
    src_mask = rng.random((B, N)) >= invalid
    tgt_mask = rng.random((B, M)) >= invalid
    init_T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    return tuple(torch.as_tensor(a, device=device)
                 for a in (src, tgt, src_mask, tgt_mask, init_T))


def fused_copy(c, src):
    """A fused carry (src_t set) holding copies of the op-by-op carry c."""
    return icp_ops.IcpCarry(*(t.clone() for t in c[:7]),
                            src_t=icp_ops._transform(src, c.T).contiguous())


def lockstep(pairs, rules, sweeps=60):
    """Yields, sweep by sweep, (before, op, fused): the op-by-op carry
    before the sweep, and the op-by-op sweep's carry and the fused sweep's,
    both advanced from `before` (the fused one from a copy with src_t = the
    sources under its T), so K4 sees the same input on both sides. rules:
    _icp_body's epsilon, max_iters, stopping_thresh, normalize_error. Stops
    when every pair of the op-by-op carry is done."""
    src, tgt, src_mask, tgt_mask, init_T = pairs
    c = icp_ops.initial_icp_carry(init_T, src.shape[1], src.dtype)
    for _ in range(sweeps):
        before = c
        fused = icp_ops._icp_body(src, tgt, src_mask, tgt_mask,
                                  fused_copy(before, src), *rules)
        c = icp_ops._icp_body(src, tgt, src_mask, tgt_mask, c, *rules)
        yield before, c, fused
        if bool(c.done.all()):
            return


def pose_gap(Ta, Tb):
    """(translation gap m, rotation gap rad) of each pair's planar
    transforms, (B, 4, 4) or SE(2) (B, 3, 3)."""
    dt = torch.linalg.norm(Ta[:, :2, -1] - Tb[:, :2, -1], dim=-1)
    yaw = lambda T: torch.atan2(T[:, 1, 0], T[:, 0, 0])  # noqa: E731
    dr = torch.remainder(yaw(Ta) - yaw(Tb) + torch.pi, 2 * torch.pi) - torch.pi
    return dt, dr.abs()
