"""The plain versions of raywalk_build's two halves: the per-owner ray lists
(raywalk_bins_plain) and the walk of each owner's list alone
(raywalk_walk_plain).

The lists are held to a brute-force test of every (owner, ray) pair with
the closed-form slot interval of the ray clipped to the owner's box (what
the kernel's clip_ray computes); the list walk is held bit for bit to the
scatter path and to the JAX package's ray-walk build in Pallas interpret
mode (v11, or v8 where an init grid is given), including init grids beyond
the clip, maps whose sides are not multiples of the owner side, S = 0 and
S = 1, and fully masked scans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.config import MapConfig as JMapConfig
from lidar_slam_tpu.ops.raywalk import build_logodds_raywalk

from lidar_slam_tpu_torch.config import MapConfig
from lidar_slam_tpu_torch.kernels.raywalk import (OWNER_SIDE, owner_grid,
                                                  raywalk_bins,
                                                  raywalk_bins_plain,
                                                  raywalk_walk_plain)
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.ops.bresenham import floordiv
from lidar_slam_tpu_torch.ops.raywalk import ray_descriptors

torch.set_num_threads(1)

_BIG = 1 << 28


def _geom(ex, ey, res=0.1):
    return dict(resolution=res, world_max_x=ex, world_min_x=-ex,
                world_max_y=ey, world_min_y=-ey)


def _scans(seed, n, r, rmax, masked=(), drift=0.0):
    """Seeded scans: rays leaving the map, axis-aligned, 45-degree and
    zero-length rays; the scans in `masked` fully masked; the robot moves
    `drift` m along x a scan on top of its random walk."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    rad = rng.uniform(0.05, rmax, (n, r))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                   -1).astype(np.float32)
    if n and r >= 4:
        pts[0, :4] = [[rmax, 0.0], [0.0, -rmax], [rmax, rmax], [1e-4, 1e-4]]
    masks = rng.random((n, r)) > 0.1
    for s in masked:
        masks[s] = False
    poses = np.cumsum(rng.normal(0, 0.4, (n, 3)), axis=0)
    poses[:, 0] += drift * np.arange(n) - drift * n / 2
    return poses.astype(np.float32), pts, masks


def _ends(poses, pts, cfg):
    return tocc.ray_ends(torch.from_numpy(poses), torch.from_numpy(pts), cfg)


def _box_interval(d, x0, x1, y0, y1):
    """The slot interval of each ray's cells inside [x0, x1] x [y0, y1]
    (raywalk.cu interval(), written over ray_descriptors' outputs)."""
    steep, sM, sm, sgM, sgm, dM, dm, c = (a.long() for a in d[:8])
    st = steep.bool()
    loM, hiM = torch.where(st, y0, x0), torch.where(st, y1, x1)
    lom, him = torch.where(st, x0, y0), torch.where(st, x1, y1)
    aM = torch.where(sgM > 0, loM - sM, sM - hiM)
    bM = torch.where(sgM > 0, hiM - sM, sM - loM)
    m_ub = torch.where(sgm > 0, him - sm, sm - lom)
    m_lb = torch.where(sgm > 0, lom - sm, sm - him)
    dms = dm.clamp(min=1)
    k_ub = torch.where(dm > 0, floordiv((m_ub + 1) * dM - 1 - c, dms),
                       torch.where(m_ub >= 0, _BIG, -1))
    k_lb = torch.where(dm > 0, -floordiv(c - m_lb * dM, dms),
                       torch.where(m_lb <= 0, -_BIG, _BIG))
    return (torch.maximum(aM.clamp(min=0), k_lb),
            torch.minimum(torch.minimum(dM, bM), k_ub))


def _brute_force_bins(ends, masks, cfg, K, side):
    """Every (owner, ray) pair tested: the ray's in-map, K-capped slots
    [k_in, k_out] intersected with its slots in the owner's box."""
    N, R = masks.shape
    d = ray_descriptors(ends.reshape(-1, 4), masks.reshape(-1), cfg, K)
    k_in, k_out = d[-2].long(), d[-1].long()
    OW, OH = owner_grid(cfg, side)
    lists = []
    for o in range(OW * OH):
        x0, y0 = o // OH * side, o % OH * side
        t_lo, t_hi = _box_interval(d, x0, x0 + side - 1, y0, y0 + side - 1)
        hit = torch.maximum(k_in, t_lo) <= torch.minimum(k_out, t_hi)
        lists.append(torch.nonzero(hit).flatten())
    counts = torch.tensor([len(x) for x in lists])
    bounds = torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)])
    return bounds.int(), torch.cat(lists).int()


CASES = {
    # name: (geometry, scans, rays, ray length, fully masked scans, drift)
    "square": (_geom(6, 6), 5, 64, 9.0, (), 0.0),
    "ragged": (_geom(3.3, 5.1), 4, 80, 7.0, (2,), 0.0),  # 67 x 103 cells
    "one_scan": (_geom(4.0, 2.2, 0.13), 1, 96, 6.0, (), 0.0),
    "first_masked": (_geom(5, 3), 4, 48, 8.0, (0,), 0.0),
    # short rays on a large map, the robot driving across it: owners that
    # scan 0 touches, owners first touched later, owners never touched
    "sparse": (_geom(8, 8), 6, 48, 3.0, (), 2.0),
}


@pytest.mark.parametrize("side", [16, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_bins_equal_brute_force(case, side):
    geom, n, r, rmax, masked, drift = CASES[case]
    cfg = MapConfig(**geom)
    poses, pts, masks = _scans(sum(map(ord, case)), n, r, rmax, masked,
                               drift)
    ends, m = _ends(poses, pts, cfg), torch.from_numpy(masks)
    K = tocc.max_ray_cells(cfg, rmax)
    bounds, entries = raywalk_bins_plain(ends, m, cfg, K, side)
    want_bounds, want_entries = _brute_force_bins(ends, m, cfg, K, side)
    assert bounds.dtype == entries.dtype == torch.int32
    assert torch.equal(bounds, want_bounds)
    assert torch.equal(entries, want_entries)
    assert int(bounds[-1]) > int(m.sum())  # rays cross several owners
    if side == OWNER_SIDE:  # the wrapper: the plain version for CPU tensors
        got = raywalk_bins(ends, m, cfg, K)
        assert all(torch.equal(a, b) for a, b in zip(got, (bounds, entries)))


def test_plain_bins_small_k_and_ray_order():
    """K = 5 cuts every ray's tail: an owner the ray only reaches past its
    fifth slot is not in its lists; every list is in (scan, ray) order."""
    cfg = MapConfig(**_geom(6, 6))
    poses, pts, masks = _scans(3, 3, 64, 9.0)
    ends, m = _ends(poses, pts, cfg), torch.from_numpy(masks)
    for K in (5, 200):
        bounds, entries = raywalk_bins_plain(ends, m, cfg, K, 16)
        want = _brute_force_bins(ends, m, cfg, K, 16)
        assert torch.equal(bounds, want[0]) and torch.equal(entries, want[1])
        for o in range(bounds.numel() - 1):
            lst = entries[int(bounds[o]):int(bounds[o + 1])]
            assert bool((lst[1:] > lst[:-1]).all())
    short, full = (int(raywalk_bins_plain(ends, m, cfg, K, 16)[0][-1])
                   for K in (5, 200))
    assert short < full


def _jax_map(poses, pts, masks, geom, K, init=None):
    """The JAX package's ray-walk build in interpret mode: v11, which runs
    v8 when given an init grid."""
    g = build_logodds_raywalk(jnp.asarray(poses), jnp.asarray(pts),
                              jnp.asarray(masks), JMapConfig(**geom), K,
                              init=None if init is None
                              else jnp.asarray(init),
                              interpret=True, version=11)
    return np.asarray(g)


def _first_scans(bounds, entries, R):
    """Per owner: its first listed scan, or -1 for an empty list."""
    out = []
    for o in range(bounds.numel() - 1):
        b, e = int(bounds[o]), int(bounds[o + 1])
        out.append(int(entries[b]) // R if e > b else -1)
    return np.array(out)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("side", [16, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_walk_bit_exact(case, side, init):
    """The list walk equals the scatter path and the JAX build bit for bit,
    on a zero grid and on an init grid uniform in [-30, 30], beyond the
    clip of 20 (owners whose lists start with scan 0 must not clip it
    before their adds, the others must)."""
    geom, n, r, rmax, masked, drift = CASES[case]
    cfg = MapConfig(**geom)
    poses, pts, masks = _scans(sum(map(ord, case)), n, r, rmax, masked,
                               drift)
    ends, m = _ends(poses, pts, cfg), torch.from_numpy(masks)
    K = tocc.max_ray_cells(cfg, rmax)
    g0 = (np.random.default_rng(n * r).uniform(
        -30, 30, (cfg.width, cfg.height)).astype(np.float32) if init
        else None)
    t0 = None if g0 is None else torch.from_numpy(g0)
    bounds, entries = raywalk_bins_plain(ends, m, cfg, K, side)
    got = raywalk_walk_plain(ends, bounds, entries, cfg, K, side, t0)
    want = tocc.build_logodds_scatter(ends, m, cfg, K, t0)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), _jax_map(poses, pts, masks, geom, K, g0))
    first = _first_scans(bounds, entries, r)
    assert (first == 0).any() == (0 not in masked)
    if case == "sparse":
        assert (first == 0).any() and (first > 0).any() and (first < 0).any()
    if init:
        assert float(got.abs().max()) == cfg.logodds_clip


def test_plain_walk_zero_and_masked_scans():
    """S = 0 leaves an init grid as it is (no scan, no clip); S = 1 of a
    fully masked scan only clips it; all-masked builds give empty lists."""
    cfg = MapConfig(**_geom(3.3, 5.1))
    K = tocc.max_ray_cells(cfg, 7.0)
    g0 = torch.as_tensor(np.random.default_rng(4).uniform(
        -30, 30, (cfg.width, cfg.height)), dtype=torch.float32)
    for n, r in ((0, 64), (1, 64), (3, 0)):
        poses, pts, masks = _scans(5, n, r, 7.0, masked=range(n))
        ends, m = _ends(poses, pts, cfg), torch.from_numpy(masks)
        bounds, entries = raywalk_bins_plain(ends, m, cfg, K, 16)
        assert entries.numel() == 0 and not bool(bounds.any())
        got = raywalk_walk_plain(ends, bounds, entries, cfg, K, 16, g0)
        assert torch.equal(got, tocc.build_logodds_scatter(ends, m, cfg, K,
                                                           g0))
        assert torch.equal(got, g0 if n == 0 else g0.clamp(-20, 20))
        zero = raywalk_walk_plain(ends, bounds, entries, cfg, K, 16)
        assert not bool(zero.any())
