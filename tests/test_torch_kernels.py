"""The Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels build at first
use) and skips without one. This file imports no JAX, so it also runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.config import MapConfig
from lidar_slam_tpu_torch.kernels import build, probes
from lidar_slam_tpu_torch.kernels.nn import nn_argmin, nn_argmin_rounded
from lidar_slam_tpu_torch.kernels import raywalk as rw
from lidar_slam_tpu_torch.kernels.raywalk import (OWNER_SIDE, raywalk_bins,
                                                  raywalk_bins_plain,
                                                  raywalk_build, raywalk_scan)
from lidar_slam_tpu_torch.models import occupancy
from lidar_slam_tpu_torch.ops.nn import gather_points, nearest_neighbors
from lidar_slam_tpu_torch.ops.raywalk import scan_delta_raywalk
from lidar_slam_tpu_torch.tools import pallas_probe, scatter_microbench
from lidar_slam_tpu_torch.tools import vpu_probe
from torch_vpu_tiles import retile

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# -- nn_argmin (csrc/nn.cu) -------------------------------------------------

def _nn_check(src, tgt, mask):
    """Kernel against the plain version on the same device: chosen-neighbour
    squared distances agree within float32 cross-term rounding (indices may
    flip only between near-equidistant targets), matched == tgt[idx] bit
    for bit, and masked targets are never chosen."""
    idx, matched = nn_argmin(src, tgt, mask)
    torch.cuda.synchronize()
    want = nearest_neighbors(src, tgt, mask)
    assert idx.dtype == torch.int32 and matched.shape == src.shape
    assert torch.equal(matched, gather_points(tgt, idx))
    d = lambda i: ((src - gather_points(tgt, i)) ** 2).sum(-1)  # noqa: E731
    gap = (d(idx) - d(want)).abs()
    assert float(gap.max()) <= 1e-5 * max(1.0, float(d(want).max()))
    assert float((idx != want).float().mean()) <= 0.01
    if mask is not None:
        assert bool(torch.gather(mask, 1, idx.long()).all())


@pytest.mark.parametrize("B,N,M,D,masked", [
    (3, 200, 150, 3, False), (2, 130, 257, 3, True), (1, 64, 90, 2, False),
    (2, 300, 2500, 3, True),  # M beyond one shared-memory stage
])
def test_nn_argmin_matches_plain(dev, B, N, M, D, masked):
    g = torch.Generator(device="cpu").manual_seed(B * N + M)
    src = torch.randn((B, N, D), generator=g).to(dev)
    tgt = torch.randn((B, M, D), generator=g).to(dev)
    mask = (torch.rand((B, M), generator=g) > 0.4).to(dev) if masked else None
    before = nn_argmin.launches
    _nn_check(src, tgt, mask)
    assert nn_argmin.launches == before + 1


def test_nn_argmin_exact_tie_lowest_index(dev):
    src = torch.tensor([[[0.5, 0.5, 0.0]]], device=dev)
    dup = [0.5, 0.6, 0.0]
    tgt = torch.tensor([[[9, 9, 9], dup, [3, 3, 3], dup, dup]],
                       dtype=torch.float32, device=dev)
    idx, matched = nn_argmin(src, tgt)
    assert int(idx[0, 0]) == 1
    mask = torch.tensor([[True, False, True, True, True]], device=dev)
    idx, matched = nn_argmin(src, tgt, mask)
    assert int(idx[0, 0]) == 3 and torch.equal(matched[0, 0], tgt[0, 3])


PLANTED = (3, 40, 700, 1050, 2100)  # lanes 3, 8, 28, 26, 20; 2100 a stage on


@pytest.mark.parametrize("B,N,M,D", [
    (1, 1081, 1081, 3), (64, 1081, 1081, 3), (3, 37, 33, 3),
    (2, 300, 2500, 3), (2, 500, 1081, 2),
])
def test_nn_argmin_equals_rounded(dev, B, N, M, D):
    """Indices equal to the kernel's arithmetic op by op, matched bit for
    bit. Copies of one target at PLANTED indices (other lanes, another
    shared-memory stage) and sources exactly on it, spread over the rows
    of every block: the lowest unmasked copy wins. The last pair of a
    batch has every target masked: index 0."""
    rng = np.random.default_rng(B * N + M + D)
    src = rng.normal(0, 5, (B, N, D)).astype(np.float32)
    tgt = rng.normal(0, 5, (B, M, D)).astype(np.float32)
    planted = [j for j in PLANTED if j < M]
    point = np.array([2.0, -1.0, 0.5][:D], np.float32)
    tgt[:, planted] = point
    src[:, ::7] = point
    mask = rng.random((B, M)) > 0.2
    mask[:, planted] = True
    mask[0, planted[0]] = False  # pair 0: the second copy wins
    if B > 1:
        mask[-1] = False
    s, t, m = (torch.from_numpy(a).to(dev) for a in (src, tgt, mask))
    before = nn_argmin.launches
    idx, matched = nn_argmin(s, t, m)
    torch.cuda.synchronize()
    assert nn_argmin.launches == before + 1
    want, want_matched = nn_argmin_rounded(s, t, m)
    assert int((idx != want).sum()) == 0
    assert torch.equal(matched.view(torch.int32),
                       want_matched.view(torch.int32))
    got = idx.cpu().numpy()
    if len(planted) > 1:
        assert (got[0, ::7] == planted[1]).all()
    if B > 2:
        assert (got[1:-1, ::7] == planted[0]).all()
    if B > 1:
        assert (got[-1] == 0).all()


def test_nn_argmin_rejects_bad_inputs(dev):
    src = torch.zeros((1, 4, 3), device=dev)
    with pytest.raises(ValueError, match="float32"):
        nn_argmin(src.double(), src.double())
    strided = torch.zeros((1, 4, 6), device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        nn_argmin(strided, strided)
    with pytest.raises(ValueError, match="D must be 2 or 3"):
        nn_argmin(torch.zeros((1, 4, 4), device=dev),
                  torch.zeros((1, 4, 4), device=dev))


# -- raywalk_build (csrc/raywalk.cu) ----------------------------------------

def _scans(seed, n, r, rmax, cfg, outside=False):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    rad = rng.uniform(0.05, rmax, (n, r))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    pts[0, :4] = [[rad[0, 0], 0.0], [0.0, -rad[0, 1]], [rad[0, 2], rad[0, 2]],
                  [1e-4, 1e-4]]  # axis-aligned, 45 degrees, zero length
    masks = rng.random((n, r)) > 0.1
    poses = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    if outside:
        poses[:, 0] += (cfg.world_max_x - cfg.world_min_x) * 0.6
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return f(poses), f(pts), torch.as_tensor(masks)


@pytest.mark.parametrize("trial", range(6))
def test_raywalk_build_bit_exact(dev, trial):
    """Seeded random map geometries (tile-ragged widths, rays leaving the
    map, robots outside it): the kernel equals the scatter path run on
    the CPU copies of the same ray end cells, bit for bit."""
    rng = np.random.default_rng(100 + trial)
    res = float(rng.choice([0.05, 0.1, 0.13, 0.25]))
    ex, ey = rng.uniform(2.0, 12.0, 2)
    cfg = MapConfig(resolution=res, world_max_x=ex, world_min_x=-ex,
                    world_max_y=ey, world_min_y=-ey)
    rmax = float(rng.uniform(0.5, 1.6)) * max(ex, ey)
    k = occupancy.max_ray_cells(cfg, rmax)
    poses, pts, masks = _scans(trial, 5, 200, rmax, cfg, trial % 3 == 0)
    ends = occupancy.ray_ends(poses, pts, cfg)
    init = (None if trial % 2 else
            torch.as_tensor(rng.normal(0, 3, (cfg.width, cfg.height)),
                            dtype=torch.float32))
    want = occupancy.build_logodds_scatter(ends, masks, cfg, k, init)
    before = raywalk_build.launches
    got = raywalk_build(ends.to(dev), masks.to(dev), cfg, k,
                        None if init is None else init.to(dev))
    torch.cuda.synchronize()
    assert raywalk_build.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert int((want != (0 if init is None else init)).sum()) > 100


def test_raywalk_build_large_k_and_clip(dev):
    cfg = MapConfig(resolution=0.025, world_max_x=10, world_min_x=-10,
                    world_max_y=10, world_min_y=-10)
    poses, pts, masks = _scans(9, 3, 64, 19.0, cfg)
    ends = occupancy.ray_ends(poses, pts, cfg)
    want = occupancy.build_logodds_scatter(ends, masks, cfg, 768)
    got = raywalk_build(ends.to(dev), masks.to(dev), cfg, 768)
    assert torch.equal(got.cpu(), want)

    cfg = MapConfig(resolution=0.5, world_max_x=3, world_min_x=-3,
                    world_max_y=3, world_min_y=-3)
    n = 40
    poses = torch.zeros((n, 3))
    pts = torch.tensor([[[1.0, 0.0]]]).expand(n, 1, 2)
    ends = occupancy.ray_ends(poses, pts, cfg)
    masks = torch.ones((n, 1), dtype=torch.bool)
    got = raywalk_build(ends.to(dev), masks.to(dev), cfg, 16)
    assert torch.equal(got.cpu(),
                       occupancy.build_logodds_scatter(ends, masks, cfg, 16))
    assert float(got.max()) == 20.0 and float(got.min()) == -20.0


def test_build_logodds_auto_takes_the_kernel(dev):
    cfg = MapConfig(resolution=0.1, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    poses, pts, masks = _scans(3, 4, 96, 9.0, cfg)
    k = occupancy.max_ray_cells(cfg, 9.0)
    before = raywalk_build.launches
    got = occupancy.build_logodds(poses.to(dev), pts.to(dev), masks.to(dev),
                                  cfg, k)
    assert raywalk_build.launches == before + 1
    want = occupancy.build_logodds(poses, pts, masks, cfg, k)
    # ray end cells come from float32 trig on two devices: compare the
    # kernel with the scatter path on the SAME end cells for exactness
    ends = occupancy.ray_ends(poses.to(dev), pts.to(dev), cfg)
    exact = occupancy.build_logodds_scatter(ends.cpu(), masks, cfg, k)
    assert torch.equal(got.cpu(), exact)
    assert float((got.cpu() != want).float().mean()) < 0.01


# -- raywalk_scan (csrc/raywalk.cu): one scan on a carried grid, in place ----

def _scan_check(dev, ends, mask, cfg, k, init, clip):
    """The kernel on a GPU copy of init against the plain version on a CPU
    copy, bit for bit; the kernel writes the grid it was given."""
    want = raywalk_scan(ends, mask, cfg, k, init.clone(), clip)
    grid = init.to(dev)
    ptr = grid.data_ptr()
    before = raywalk_scan.launches
    out = raywalk_scan(ends.to(dev), mask.to(dev), cfg, k, grid, clip)
    torch.cuda.synchronize()
    assert raywalk_scan.launches == before + 1
    assert out is grid and grid.data_ptr() == ptr
    assert torch.equal(grid.cpu(), want)
    return want


@pytest.mark.parametrize("clip", [20.0, None])
@pytest.mark.parametrize("trial", range(4))
def test_raywalk_scan_bit_exact(dev, trial, clip):
    """Seeded random geometries, a random carried grid (beyond the clip, so
    the clip shows), robots inside and outside the map."""
    rng = np.random.default_rng(200 + trial)
    res = float(rng.choice([0.05, 0.1, 0.13, 0.25]))
    ex, ey = rng.uniform(2.0, 12.0, 2)
    cfg = MapConfig(resolution=res, world_max_x=ex, world_min_x=-ex,
                    world_max_y=ey, world_min_y=-ey)
    rmax = float(rng.uniform(0.5, 1.6)) * max(ex, ey)
    k = occupancy.max_ray_cells(cfg, rmax)
    poses, pts, masks = _scans(trial, 1, 700, rmax, cfg, trial == 3)
    ends = occupancy.ray_ends(poses[0], pts[0], cfg)
    init = torch.as_tensor(rng.uniform(-25, 25, (cfg.width, cfg.height)),
                           dtype=torch.float32)
    got = _scan_check(dev, ends, masks[0], cfg, k, init, clip)
    if clip is not None:
        assert float(got.abs().max()) == clip
    else:
        assert float(got.abs().max()) > 20.0  # nothing clipped
    assert int((got != init).sum()) > 100


def test_raywalk_scan_large_k_masked_and_off_map(dev):
    cfg = MapConfig(resolution=0.025, world_max_x=10, world_min_x=-10,
                    world_max_y=10, world_min_y=-10)
    poses, pts, masks = _scans(9, 1, 300, 19.0, cfg)
    ends = occupancy.ray_ends(poses[0], pts[0], cfg)
    init = torch.as_tensor(np.random.default_rng(1).uniform(
        -20, 20, (cfg.width, cfg.height)), dtype=torch.float32)
    for clip in (20.0, None):
        _scan_check(dev, ends, masks[0], cfg, 768, init, clip)
        # a fully masked scan and a scan whose rays never reach the map
        # leave the grid as it was, with or without the clip
        none = torch.zeros_like(masks[0])
        assert torch.equal(_scan_check(dev, ends, none, cfg, 768, init, clip),
                           init)
        far = occupancy.ray_ends(poses[0] + torch.tensor([100.0, 0, 0]),
                                 pts[0], cfg)
        assert torch.equal(_scan_check(dev, far, masks[0], cfg, 768, init,
                                       clip), init)


def test_update_map_and_scan_delta_take_the_kernel(dev):
    cfg = MapConfig(resolution=0.05, world_max_x=30, world_min_x=-30,
                    world_max_y=30, world_min_y=-30)
    poses, pts, masks = _scans(4, 1, 1081, 30.0, cfg)
    pose, pt, m = poses[0].to(dev), pts[0].to(dev), masks[0].to(dev)
    k = occupancy.max_ray_cells(cfg, 30.0)
    ends = occupancy.ray_ends(pose, pt, cfg)
    before = raywalk_scan.launches
    delta = scan_delta_raywalk(pose, pt, m, cfg, k)
    grid = torch.zeros((cfg.width, cfg.height), device=dev)
    out = occupancy.update_map(grid, pose, pt, m, cfg, k)
    torch.cuda.synchronize()
    assert raywalk_scan.launches == before + 2 and out is grid
    zero = torch.zeros((cfg.width, cfg.height))
    want = occupancy.scatter_scan_(zero.clone(), ends.cpu(), masks[0], cfg,
                                   k)
    assert torch.equal(delta.cpu(), want)
    assert torch.equal(grid.cpu(), want.clamp(-20.0, 20.0))
    assert float(want.min()) < -20.0  # the delta is unclipped


def _box(W, H):
    """A map of W x H cells of 1 m: cell (i, j) at world (i, j)."""
    return MapConfig(resolution=1.0, world_min_x=0.0, world_max_x=W - 1.0,
                     world_min_y=0.0, world_max_y=H - 1.0)


def _fan(rng, sx, sy, n, length):
    """n rays from cell (sx, sy) in every direction, up to length cells."""
    ang = rng.uniform(-np.pi, np.pi, n)
    rad = rng.uniform(0.0, length, n)
    return np.stack([np.full(n, sx), np.full(n, sy),
                     np.rint(sx + rad * np.cos(ang)),
                     np.rint(sy + rad * np.sin(ang))], -1)


def _stress_case(case):
    """(ends (R, 4) int32, mask, W, H, K) of one K2 stress case."""
    rng = np.random.default_rng(sum(case.encode()))
    W, H, K = 200, 170, 608
    if case == "one_cell":  # the robot's sub-tile walks all 1,081 rays
        W = H = 601
        ends = _fan(rng, 300, 300, 1081, 420.0)
    elif case in ("edge_31", "edge_32", "corner_31_32", "corner_32_31"):
        # the robot on the last or first cell of a sub-tile (and of a
        # 64-cell block at 64 + 31, 64 + 32)
        off = {"edge_31": (31, 31), "edge_32": (32, 32),
               "corner_31_32": (31, 32), "corner_32_31": (32, 31)}[case]
        ends = np.concatenate([_fan(rng, 64 + off[0], 64 + off[1], 700, 90.0),
                               _fan(rng, 96 + off[0], 32 + off[1], 381, 60.0)])
    elif case == "exact_32":
        # axis-aligned, steep and 45-degree rays of exactly 32 slots inside
        # one sub-tile, both ways, and 33 slots across a sub-tile edge
        x0, y0, rows = 64, 96, []
        a, b = x0 + 31, y0 + 31
        for i in range(32):
            rows += [(x0, y0 + i, a, y0 + i), (a, y0 + i, x0, y0 + i),
                     (x0 + i, y0, x0 + i, b), (x0 + i, b, x0 + i, y0),
                     (x0, y0, a, b), (a, b, x0, y0),
                     (x0, b, a, y0), (a, y0, x0, b),
                     (x0 - 1, y0 + i, a, y0 + i), (x0 + i, y0, x0 + i, b + 1)]
        ends = np.array(rows)
    elif case == "ragged":  # W, H not multiples of 32; rays leave the map
        W, H = 97, 75
        ends = np.concatenate([_fan(rng, 48, 37, 600, 120.0),
                               _fan(rng, 96, 0, 300, 80.0),
                               _fan(rng, -5, 80, 181, 100.0)])
    else:  # "small_k": tails truncated at K = 5 slots
        K = 5
        ends = _fan(rng, 100, 90, 1081, 60.0)
    mask = rng.random(len(ends)) > 0.05
    return (torch.as_tensor(ends, dtype=torch.int32), torch.as_tensor(mask),
            W, H, K)


@pytest.mark.parametrize("clip", [20.0, None])
@pytest.mark.parametrize("case", [
    "one_cell", "edge_31", "edge_32", "corner_31_32", "corner_32_31",
    "exact_32", "ragged", "small_k",
])
def test_raywalk_scan_stress(dev, case, clip):
    """The warp-owned sub-tile walk at its edges, bit-exact against the
    scatter path on CPU copies, on a random carried grid beyond the clip;
    with the clip and without it (the lazy-load path)."""
    ends, mask, W, H, K = _stress_case(case)
    cfg = _box(W, H)
    init = torch.as_tensor(np.random.default_rng(W + H).uniform(
        -25, 25, (W, H)), dtype=torch.float32)
    got = _scan_check(dev, ends, mask, cfg, K, init, clip)
    before = init if clip is None else init.clamp(-clip, clip)
    assert int((got != before).sum()) > 50


def _axis_rays(x0, y0, n):
    """Rays of n cells along +x, -x, +y, -y and the four diagonals from
    (x0, y0), and their reverses."""
    rows = []
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1),
                   (1, -1), (-1, 1)):
        ex, ey = x0 + dx * (n - 1), y0 + dy * (n - 1)
        rows += [(x0, y0, ex, ey), (ex, ey, x0, y0)]
    return rows


def _build_case(case):
    """(ends (S, R, 4) int32, masks, W, H, K) of one K1 stress case: scans
    of R rays each; scan 1 fully masked where S > 2."""
    rng = np.random.default_rng(sum(case.encode()))
    W, H, K, S, R = 200, 170, 608, 6, 400
    side = OWNER_SIDE
    if case == "axes_45":  # rays along both axes and at 45 degrees, from
        # cells on and beside owner edges
        rows = []
        for x0, y0 in ((side - 1, side), (side, side - 1), (2 * side, 40),
                       (100, 2 * side - 1), (57, 3 * side)):
            for n in (1, 2, side - 1, side, side + 1, 70):
                rows += _axis_rays(x0, y0, n)
        scans = [np.array(rows)] * S
    elif case == "leaving":  # rays leaving the map; robots off the map
        scans = [np.concatenate([_fan(rng, sx, sy, R // 2, 300.0),
                                 _fan(rng, sx2, sy2, R // 2, 300.0)])
                 for sx, sy, sx2, sy2 in rng.integers(-40, 240, (S, 4))]
    elif case == "small_k":  # tails truncated at K = 5 slots
        K = 5
        scans = [_fan(rng, *rng.integers(0, 170, 2), R, 60.0)
                 for _ in range(S)]
    elif case == "one_by_n":  # a 1 x N map
        W, H = 1, 300
        scans = [_fan(rng, rng.integers(-2, 3), rng.integers(0, 300), R,
                      80.0) for _ in range(S)]
    elif case == "owner_plus_one":  # one owner and a row and column more
        W = H = side + 1
        scans = [_fan(rng, *rng.integers(0, side + 1, 2), R, 50.0)
                 for _ in range(S)]
    elif case == "one_scan":
        S = 1
        scans = [_fan(rng, 100, 90, 1081, 150.0)]
    else:  # "hot": every ray of every scan from one cell, past 32 a batch
        W = H = 601
        scans = [_fan(rng, 300, 300, 1081, 420.0) for _ in range(S)]
    ends = np.stack(scans).astype(np.int32)
    masks = rng.random(ends.shape[:2]) > 0.05
    if S > 2:
        masks[1] = False
    return torch.as_tensor(ends), torch.as_tensor(masks), W, H, K


BUILD_CASES = ["axes_45", "leaving", "small_k", "one_by_n", "owner_plus_one",
               "one_scan", "hot"]


@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("case", BUILD_CASES)
def test_raywalk_build_stress(dev, case, init):
    """The per-owner list walk at its edges, bit-exact against the scatter
    path on CPU copies; on a zero grid and on an init grid beyond the clip
    (owners whose lists start after scan 0 clip it at load, the others
    add first)."""
    ends, masks, W, H, K = _build_case(case)
    cfg = _box(W, H)
    g0 = (torch.as_tensor(np.random.default_rng(W * H).uniform(
        -30, 30, (W, H)), dtype=torch.float32) if init else None)
    want = occupancy.build_logodds_scatter(ends, masks, cfg, K, g0)
    before = raywalk_build.launches
    got = raywalk_build(ends.to(dev), masks.to(dev), cfg, K,
                        None if g0 is None else g0.to(dev))
    torch.cuda.synchronize()
    assert raywalk_build.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert int((want != (0 if g0 is None else g0.clamp(-20, 20))).sum()) > 20


@pytest.mark.parametrize("case", BUILD_CASES)
def test_raywalk_bins_equal_plain(dev, case):
    """The binning kernel's lists (count, scan, ordered fill) equal the
    plain lists, entry for entry."""
    ends, masks, W, H, K = _build_case(case)
    cfg = _box(W, H)
    bounds, entries = raywalk_bins(ends.to(dev), masks.to(dev), cfg, K)
    torch.cuda.synchronize()
    want_bounds, want_entries = raywalk_bins_plain(ends, masks, cfg, K)
    assert torch.equal(bounds.cpu(), want_bounds)
    assert torch.equal(entries.cpu(), want_entries)
    assert entries.numel() > 0


def test_raywalk_bins_large_chunk(dev, monkeypatch):
    """Where the count matrix would pass TABLE_CAP, a warp bins more than
    BIN_CHUNK rays, a count that is not a multiple of 1,024: the lists still
    equal the plain lists, and the build stays bit-exact."""
    rng = np.random.default_rng(11)
    W = H = 130  # 9 x 9 owners
    cfg = _box(W, H)
    ends = torch.as_tensor(np.stack([
        _fan(rng, *rng.integers(0, W, 2), 181, 90.0) for _ in range(60)
    ]).astype(np.int32))
    masks = torch.as_tensor(rng.random(ends.shape[:2]) > 0.05)
    monkeypatch.setattr(rw, "TABLE_CAP", 512)
    chunk = rw.bin_chunk(60 * 181, 81)
    assert chunk > rw.BIN_CHUNK and chunk % 1024 and -(-60 * 181 // chunk) > 2
    bounds, entries = raywalk_bins(ends.to(dev), masks.to(dev), cfg, 608)
    want_bounds, want_entries = raywalk_bins_plain(ends, masks, cfg, 608)
    assert torch.equal(bounds.cpu(), want_bounds)
    assert torch.equal(entries.cpu(), want_entries)
    got = raywalk_build(ends.to(dev), masks.to(dev), cfg, 608)
    assert torch.equal(got.cpu(), occupancy.build_logodds_scatter(
        ends, masks, cfg, 608))


def test_raywalk_build_no_scans_or_all_masked(dev):
    """S = 0 returns the init grid as it is; scans that are all masked, or
    of no rays, only clip it."""
    cfg = _box(70, 45)
    g0 = torch.as_tensor(np.random.default_rng(2).uniform(-30, 30, (70, 45)),
                         dtype=torch.float32)
    for S, R in ((0, 16), (3, 16), (2, 0)):
        ends = torch.zeros((S, R, 4), dtype=torch.int32)
        masks = torch.zeros((S, R), dtype=torch.bool)
        got = raywalk_build(ends.to(dev), masks.to(dev), cfg, 64, g0.to(dev))
        want = g0 if S == 0 else g0.clamp(-20, 20)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got.cpu(), occupancy.build_logodds_scatter(
            ends, masks, cfg, 64, g0))


def test_raywalk_scan_rejects_bad_inputs(dev):
    cfg = MapConfig(resolution=0.5, world_max_x=3, world_min_x=-3,
                    world_max_y=3, world_min_y=-3)
    ends = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    grid = torch.zeros((cfg.width, cfg.height), device=dev)
    with pytest.raises(ValueError, match="grid must be"):
        raywalk_scan(ends, mask, cfg, 8, grid.double(), None)
    with pytest.raises(ValueError, match="grid must be"):
        raywalk_scan(ends, mask, cfg, 8, grid.cpu(), None)
    with pytest.raises(ValueError, match="contiguous"):
        raywalk_scan(ends, mask, cfg, 8, grid.t().contiguous().t(), None)
    with pytest.raises(ValueError, match="ends must be"):
        raywalk_scan(ends[None], mask, cfg, 8, grid, None)


# -- the probes P1-P9 (csrc/probes.cu): bit-exact against the plain versions

def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", list(pallas_probe.KERNELS))
def test_construct_probe_bit_exact(dev, name):
    """P1-P6 on the JAX tool's inputs."""
    wrapper = pallas_probe.KERNELS[name]
    before = wrapper.launches
    got = pallas_probe.call(name, dev)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _same_bits(got, pallas_probe.call(name, "cpu"))


@pytest.mark.parametrize("case,n", [
    ("mixed", 0), ("mixed", 1), ("mixed", 31), ("mixed", 33),
    ("mixed", 64), ("alternating", 4096), ("mixed", 4096),
    ("negative_zero", 64)])
def test_smem_stream_bit_exact(dev, case, n):
    """P1 against its plain version: every tile cell the in-order fold of
    the entries (signs and magnitudes 1e-3 to 1e8, or [1e8, 1, -1e8, 1]
    repeated, whose in-order sum is 1.0), or +0.0 from entries of -0.0;
    every other cell +0.0."""
    rng = np.random.default_rng(n + 3)
    if case == "alternating":
        xs = np.tile(np.float32([1e8, 1.0, -1e8, 1.0]), n // 4)
    elif case == "negative_zero":
        xs = np.full(n, -0.0, np.float32)
    else:
        xs = (rng.choice([-1.0, 1.0], n)
              * 10.0 ** rng.uniform(-3, 8, n)).astype(np.float32)
    xs = torch.from_numpy(xs)
    before = probes.smem_stream.launches
    got = probes.smem_stream(xs.to(dev))
    torch.cuda.synchronize()
    assert probes.smem_stream.launches == before + 1
    _same_bits(got, probes.smem_stream_plain(xs))
    if case == "alternating":
        assert float(got[0, 0]) == 1.0


def _tile_entries(case: str, n: int):
    """(xs, ys) CPU int32 tensors of one P2-P4 case of n entries."""
    rng = np.random.default_rng(n + 11)
    W, H = probes.PROBE_SHAPE
    if case == "off_grid":  # negative and past the grid on every side
        return _int32(rng, -40, W + 40, n), _int32(rng, -400, H + 400, n)
    xs, ys = _int32(rng, 0, W, n), _int32(rng, 0, H, n)
    if case == "hot_tile":  # seven in eight entries on tile (5, 1)
        hot = torch.as_tensor(rng.random(n) < 7 / 8)
        xs[hot] = _int32(rng, 40, 48, int(hot.sum()))
        ys[hot] = _int32(rng, 128, 256, int(hot.sum()))
    if case == "hot_cell":  # 4,096 entries on cell (21, 200)
        hot = torch.as_tensor(rng.choice(n, 4096, replace=False))
        xs[hot], ys[hot] = 21, 200
    if case == "saturated":  # every entry on tile (2, 0): S_k = 2^24
        xs, ys = _int32(rng, 16, 24, n), _int32(rng, 0, 128, n)
    return xs, ys


TILE_CASES = [("random", 0), ("random", 1), ("random", 64), ("random", 1000),
              ("random", 100_000), ("hot_tile", 65_536), ("off_grid", 5000)]


@pytest.mark.parametrize("case,n", TILE_CASES + [("saturated", 2**24 + 5)])
def test_dynamic_lane_store_bit_exact(dev, case, n):
    """P3's counting kernel against its design (and its plain version,
    one tile add an entry, up to 5,000 entries), bit for bit: no entries,
    a hot tile, entries off the grid on every side, and a tile hit more
    than 2^24 times, where the float32 fold of 1.0 stops at 2^24."""
    xs, ys = _tile_entries(case, n)
    before = probes.dynamic_lane_store.launches
    got = probes.dynamic_lane_store(xs.to(dev), ys.to(dev))
    torch.cuda.synchronize()
    assert probes.dynamic_lane_store.launches == before + 1
    want = probes.dynamic_lane_store_design(xs, ys)
    _same_bits(got, want)
    if n <= 5000:
        _same_bits(got, probes.dynamic_lane_store_plain(xs, ys))
    if case == "saturated":
        assert float(want[16, 0]) == 2.0**24
    assert bool(want.any()) == (n > 0)


@pytest.mark.parametrize("case,n", TILE_CASES + [("saturated", 2**24 + 5)])
def test_dynamic_store_bit_exact(dev, case, n):
    """P2's counting kernel (P3's on lane tile 0) against its design (and
    its plain version up to 5,000 entries), bit for bit, on P3's cases: a
    row band hit more than 2^24 times writes 2^24."""
    xs = _tile_entries(case, n)[0]
    before = probes.dynamic_store.launches
    got = probes.dynamic_store(xs.to(dev))
    torch.cuda.synchronize()
    assert probes.dynamic_store.launches == before + 1
    want = probes.dynamic_store_design(xs)
    _same_bits(got, want)
    if n <= 5000:
        _same_bits(got, probes.dynamic_store_plain(xs))
    if case == "saturated":
        assert float(want[16, 0]) == 2.0**24
    assert bool(want.any()) == (n > 0)


@pytest.mark.parametrize("case,n", TILE_CASES + [("hot_cell", 65_536)])
def test_masked_tile_bit_exact(dev, case, n):
    """P4's counting kernel (a hit count a cell, the k-fold sum of -1.386
    written once) against its design (and its plain version up to 5,000
    entries), bit for bit, on P3's cases and with one cell hit 4,096 times
    among 65,536 entries."""
    xs, ys = _tile_entries(case, n)
    before = probes.masked_tile.launches
    got = probes.masked_tile(xs.to(dev), ys.to(dev))
    torch.cuda.synchronize()
    assert probes.masked_tile.launches == before + 1
    want = probes.masked_tile_design(xs, ys)
    _same_bits(got, want)
    if n <= 5000:
        _same_bits(got, probes.masked_tile_plain(xs, ys))
    if case == "hot_cell":
        assert float(want[21, 200]) < -1.386 * 4000
    assert bool(want.any()) == (n > 0)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 64, 4096, 100_003])
def test_scalar_sum_bit_exact(dev, n):
    """P5's one-warp fold against the plain in-order loop on values whose
    float32 sum depends on the order (signs and magnitudes 1e-3 to 1e8),
    at lengths around and across its 32-entry chunks."""
    rng = np.random.default_rng(n)
    xs = torch.as_tensor(rng.choice([-1.0, 1.0], n)
                         * 10.0 ** rng.uniform(-3, 8, n), dtype=torch.float32)
    before = probes.scalar_sum.launches
    got = probes.scalar_sum(xs.to(dev))
    torch.cuda.synchronize()
    assert probes.scalar_sum.launches == before + 1
    _same_bits(got, probes.scalar_sum_plain(xs))


def _int32(rng, lo, hi, n):
    return torch.as_tensor(rng.integers(lo, hi, n), dtype=torch.int32)


def _tile_rmw_args(case: str):
    """(xs, ys, vs) CPU tensors of one P7 case."""
    rng = np.random.default_rng(8)
    W, H = probes.GRID_SHAPE
    if case.startswith("rays_"):
        return tuple(map(torch.from_numpy, scatter_microbench.make_updates(
            int(case.split("_")[1]), 3)))
    u = {"random": 50_000, "hot_cell": 200_000, "empty": 0,
         "outside": 20_000, "single_tile": 30_000,
         "signed_zeros": 20_000}[case]
    vs = torch.as_tensor(rng.choice([-1.0, 1.0], u)
                         * 10.0 ** rng.uniform(-3, 3, u), dtype=torch.float32)
    if case == "random":  # cells outside the grid included (dropped)
        return (_int32(rng, -20, W + 20, u), _int32(rng, -20, H + 20, u),
                torch.as_tensor(rng.normal(0, 1e3, u), dtype=torch.float32))
    if case == "outside":
        return (_int32(rng, W, W + 100, u), _int32(rng, -50, H, u), vs)
    if case == "single_tile":  # one (8, 128) owner tile
        return _int32(rng, 600, 608, u), _int32(rng, 512, 640, u), vs
    if case == "signed_zeros":  # +-0.0 among +-1.5 on a 4 x 4 patch
        return (_int32(rng, 300, 304, u), _int32(rng, 700, 704, u),
                torch.as_tensor(rng.choice([-0.0, 0.0, 1.5, -1.5], u),
                                dtype=torch.float32))
    xs, ys = _int32(rng, 0, W, u), _int32(rng, 0, H, u)
    if case == "hot_cell":  # a quarter of the adds on one cell, in order
        hot = torch.as_tensor(rng.choice(u, u // 4, replace=False))
        xs[hot], ys[hot] = 601, 300
    return xs, ys, vs


@pytest.mark.parametrize("case", ["rays_4096", "rays_100000", "random",
                                  "hot_cell", "empty", "outside",
                                  "single_tile", "signed_zeros"])
def test_tile_rmw_bit_exact(dev, case):
    """P7: ray-shaped updates (many adds per cell, in order), random ones
    including cells outside the grid (dropped), one cell taking a quarter
    of 200,000 adds of mixed sign and magnitude, none, all outside the
    grid, all in one owner tile, and signed zeros among +-1.5."""
    args = _tile_rmw_args(case)
    before = probes.tile_rmw.launches
    got = probes.tile_rmw(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert probes.tile_rmw.launches == before + 1
    want = probes.tile_rmw(*args)
    _same_bits(got, want)
    assert bool(want.any()) == (case not in ("empty", "outside"))


def _segment_args(case: str):
    """(x8, yl, a, b) CPU tensors of one P8 case."""
    rng = np.random.default_rng(9)
    W, H = probes.GRID_SHAPE
    n = 5000
    if case == "aligned":
        return tuple(map(torch.from_numpy,
                         scatter_microbench.seg_args(n, 2)))
    if case == "unaligned":  # a segment spans two row bands; some outside
        return (_int32(rng, -10, W, n), _int32(rng, -100, H, n),
                _int32(rng, -1024, 1024, n), _int32(rng, -8192, 8192, n))
    if case == "outside":
        return (_int32(rng, W, W + 50, n), _int32(rng, -100, H, n),
                _int32(rng, -1024, 1024, n), _int32(rng, -8192, 8192, n))
    if case == "empty":
        return tuple(torch.zeros(0, dtype=torch.int32) for _ in range(4))
    # single tile: 50,000 segments on one tile in 10 line shapes, so each
    # cell of a line takes about 5,000 adds
    k = torch.as_tensor(rng.integers(0, 10, 50_000), dtype=torch.int32)
    return (torch.full_like(k, 600), torch.full_like(k, 512), 100 * k + 1,
            700 * k)


@pytest.mark.parametrize("case", ["aligned", "unaligned", "single_tile",
                                  "empty", "outside"])
def test_segment_rmw_bit_exact(dev, case):
    """P8 on the tool's segments, on unaligned tile offsets (a segment then
    spans two row bands) partly outside the grid, on one tile hit 50,000
    times, on no segments and on segments all outside the grid."""
    args = _segment_args(case)
    before = probes.segment_rmw.launches
    got = probes.segment_rmw(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert probes.segment_rmw.launches == before + 1
    want = probes.segment_rmw(*args)
    _same_bits(got, want)
    assert int((want != 0).sum()) > {"aligned": 1000, "unaligned": 1000,
                                     "single_tile": 90}.get(case, -1)
    assert bool(want.any()) == (case not in ("empty", "outside"))


@pytest.mark.parametrize("mode,n_pairs,reps", [
    *((m, 64, 3) for m in probes.VPU_MODES),
    ("fullv", 3000, 1),  # more pairs than one shared-memory stage
    ("ray2", 4100, 1),  # the ray table wraps at 4,096 columns
])
def test_vpu_loop_bit_exact(dev, mode, n_pairs, reps):
    """P9 in place on a random carried grid."""
    rays = mode in ("ray1", "ray2")
    words = torch.from_numpy(vpu_probe.words_for(n_pairs, 5, rays=rays))
    grid = torch.as_tensor(np.random.default_rng(6).normal(
        0, 1, (vpu_probe.GRID, vpu_probe.GRID)), dtype=torch.float32)
    want = probes.vpu_loop(words, grid.clone(), n_pairs, mode, reps)
    g = grid.to(dev)
    before = probes.vpu_loop.launches
    out = probes.vpu_loop(words.to(dev), g, n_pairs, mode, reps)
    torch.cuda.synchronize()
    assert probes.vpu_loop.launches == before + 1 and out is g
    _same_bits(g, want)
    assert int((want != grid).sum()) > 100


# P9 beyond the tool's grid: (words' tile rows and lane tiles, grid shape)
VPU_600x700 = ((0, 12), (0, 8)), (600, 700)  # tile positions partly and
# wholly outside the grid
VPU_HOT = ((3, 4), (2, 3)), (vpu_probe.GRID, vpu_probe.GRID)  # one tile


@pytest.mark.parametrize("mode,n_pairs,reps,where", [
    *((m, 1000, 2, VPU_600x700) for m in probes.VPU_MODES),
    ("ray1", 3000, 2, VPU_600x700),  # no power of two: j = i & 2999
    # every visit on one tile: its lists exceed the 4,096 entries a block
    # holds, so they are filtered and walked in parts every repetition
    ("full", 5000, 2, VPU_HOT), ("fullv", 5000, 2, VPU_HOT),
    ("ray2", 4100, 2, VPU_HOT),
    # 40,000 visits a repetition: the filter takes 40 chunks
    ("full", 20000, 1, None), ("fullv", 20000, 1, None),
    ("full", 0, 2, None), ("ray2", 64, 0, None),  # nothing to do
])
def test_vpu_loop_edge_cases(dev, mode, n_pairs, reps, where):
    """P9 in place, bit-exact, where owners and lists are at their edges."""
    words = vpu_probe.words_for(max(n_pairs, 1), 7,
                                rays=mode in ("ray1", "ray2"))
    shape = (vpu_probe.GRID, vpu_probe.GRID)
    if where:
        tiles, shape = where
        words = retile(words, tiles, 7)
    words = torch.from_numpy(words)
    grid = torch.as_tensor(np.random.default_rng(8).normal(0, 1, shape),
                           dtype=torch.float32)
    want = probes.vpu_loop(words, grid.clone(), n_pairs, mode, reps)
    g = grid.to(dev)
    before = probes.vpu_loop.launches
    probes.vpu_loop(words.to(dev), g, n_pairs, mode, reps)
    torch.cuda.synchronize()
    assert probes.vpu_loop.launches == before + 1
    _same_bits(g, want)
    assert int((want != grid).sum()) > (100 if n_pairs and reps else -1)


def test_cuda_raw_bindings_are_torchs_current_device_and_stream(dev):
    """This torch still has the private bindings the wrappers launch with,
    and they give what the public API gives, on the default stream and on
    a side stream."""
    build.cuda_raw.cache_clear()
    get_device, raw_stream = build.cuda_raw()
    assert get_device() == torch.cuda.current_device()
    index = get_device()
    assert raw_stream(index) == torch.cuda.current_stream(index).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert raw_stream(index) == side.cuda_stream


@pytest.mark.parametrize("device", [torch.device("cuda"), "cuda:0",
                                    torch.device("cuda", 0)])
def test_full_grid_switches_no_device(dev, device, monkeypatch):
    """P6 on the current device, however it is named, launches once and
    enters no torch.cuda.device context."""
    entered = []

    class Recording(torch.cuda.device):
        def __init__(self, device):
            entered.append(device)
            super().__init__(device)

    torch.cuda.set_device(0)
    monkeypatch.setattr(torch.cuda, "device", Recording)
    before = probes.full_grid.launches
    got = probes.full_grid(device)
    assert not entered  # (torch.cuda.synchronize enters one itself)
    torch.cuda.synchronize()
    assert probes.full_grid.launches == before + 1
    _same_bits(got, probes.full_grid("cpu"))


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_main_path_kernels_switch_no_device(dev, device, monkeypatch):
    """K4, K1 (binning and walk) and K2 on tensors of the current device,
    named with or without its index, launch through build.Entry: no
    torch.cuda.device context is entered, and each equals its plain
    version on the CPU."""
    cfg = MapConfig(resolution=0.1, world_max_x=6, world_min_x=-6,
                    world_max_y=6, world_min_y=-6)
    poses, pts, masks = _scans(5, 3, 200, 9.0, cfg)
    k = occupancy.max_ray_cells(cfg, 9.0)
    ends = occupancy.ray_ends(poses, pts, cfg)
    g = torch.Generator().manual_seed(3)
    src, tgt = torch.randn((1, 300, 3), generator=g), torch.randn(
        (1, 400, 3), generator=g)
    mask = torch.rand((1, 400), generator=g) > 0.3
    grid = torch.as_tensor(np.random.default_rng(2).uniform(
        -25, 25, (cfg.width, cfg.height)), dtype=torch.float32)
    on = [t.to(device) for t in (src, tgt, mask, ends, masks, grid)]
    entered = []

    class Recording(torch.cuda.device):
        def __init__(self, device):
            entered.append(device)
            super().__init__(device)

    torch.cuda.set_device(0)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch.cuda, "device", Recording)
    counts = [f.launches for f in (nn_argmin, raywalk_build, raywalk_scan)]
    idx, matched = nn_argmin(*on[:3])
    built = raywalk_build(on[3], on[4], cfg, k)
    raywalk_scan(on[3][0], on[4][0], cfg, k, on[5], 20.0)
    assert not entered  # (torch.cuda.synchronize enters one itself)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert [f.launches for f in (nn_argmin, raywalk_build, raywalk_scan)] \
        == [c + 1 for c in counts]
    want_idx, want_matched = nn_argmin_rounded(*on[:3])
    assert torch.equal(idx, want_idx) and torch.equal(matched, want_matched)
    assert torch.equal(built.cpu(),
                       occupancy.build_logodds_scatter(ends, masks, cfg, k))
    assert torch.equal(on[5].cpu(), raywalk_scan(ends[0], masks[0], cfg, k,
                                                 grid.clone(), 20.0))


@pytest.mark.parametrize("offset,n", [(0, 1_000_003), (1, 1_000_001),
                                      (3, 2), (2, 0), (1, 7)])
def test_fill_entry_any_length_and_alignment(dev, offset, n):
    """P6's C entry point writes exactly out[0, n) for any n and any
    4-byte aligned out: a scalar head up to the first 16-byte boundary,
    float4s, a scalar tail."""
    buf = torch.full((n + 8,), -7.0, device=dev)
    rc = build.library().slam_probe_fill(
        buf.data_ptr() + 4 * offset, n, 2.5,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = torch.full((n + 8,), -7.0)
    want[offset:offset + n] = 2.5
    _same_bits(buf, want)


def test_probe_wrappers_reject_bad_inputs(dev):
    xs = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="one length"):
        probes.masked_tile(xs, xs[:4])
    with pytest.raises(ValueError, match="xs must be"):
        probes.dynamic_store(xs.float())
    with pytest.raises(ValueError, match="contiguous"):
        probes.tile_rmw(xs[::2], xs[::2], xs[::2].float())
    with pytest.raises(ValueError, match="words must be"):
        probes.vpu_loop(xs.view(4, 2), torch.zeros((512, 512), device=dev),
                        4, "full", 1)
    with pytest.raises(ValueError, match="grid must be"):
        probes.vpu_loop(xs.view(4, 2), torch.zeros((512, 512), device=dev,
                                                   dtype=torch.float64),
                        2, "full", 1)
