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
from lidar_slam_tpu_torch.kernels.nn import nn_argmin
from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
from lidar_slam_tpu_torch.models import occupancy
from lidar_slam_tpu_torch.ops.nn import gather_points, nearest_neighbors

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
