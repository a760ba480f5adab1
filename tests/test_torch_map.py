"""Bit-exact parity of the port's occupancy map with the JAX package.

The port builds the map from each ray's integer start and end cells; the
integer walk descriptors are checked first, so a float rounding difference
in the ray end cells is told apart from a walk bug. On CPU tensors the
port's map build is the scatter path (the plain version of the Hopper
ray-walk kernel), which must equal the JAX scatter path and every JAX
ray-walk kernel generation (Pallas interpret mode) bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_slam_tpu.config import MapConfig as JMapConfig
from lidar_slam_tpu.models import occupancy as jocc
from lidar_slam_tpu.ops.bresenham import bresenham_fixed as j_bresenham
from lidar_slam_tpu.ops.raywalk import build_logodds_raywalk
from lidar_slam_tpu.ops.raywalk import ray_descriptors as j_descriptors

from lidar_slam_tpu_torch.config import MapConfig
from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.ops.bresenham import bresenham_fixed
from lidar_slam_tpu_torch.ops.raywalk import ray_descriptors

torch.set_num_threads(1)

_GEOM = dict(resolution=0.1, world_max_x=6, world_min_x=-6,
             world_max_y=6, world_min_y=-6)
JCFG, TCFG = JMapConfig(**_GEOM), MapConfig(**_GEOM)
K = tocc.max_ray_cells(TCFG, 9.0)


def _adversarial_scans(seed=0, n=10, r=96):
    """tests/test_raywalk.py's scans: endpoints leaving the map, zero-length
    and axis-aligned rays, a fully masked scan."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    rad = rng.uniform(0.2, 9.0, (n, r))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                   axis=-1).astype(np.float32)
    masks = rng.random((n, r)) > 0.1
    pts[0, :4] = 0.001
    pts[1, 4] = [3.0, 0.0]
    pts[1, 5] = [0.0, -4.5]
    pts[1, 6] = [-2.0, 0.0]
    masks[2, :] = False
    poses = np.cumsum(rng.normal(0, 0.15, (n, 3)), axis=0).astype(np.float32)
    poses[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return poses, pts, masks


def _jax_map(poses, pts, masks, cfg, k, init=None, version=None):
    args = (jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(masks), cfg, k)
    init = None if init is None else jnp.asarray(init)
    if version is None:
        return np.asarray(jocc.build_logodds(*args, init=init,
                                             backend="scatter"))
    return np.asarray(build_logodds_raywalk(*args, init=init, interpret=True,
                                            version=version))


def _port_map(poses, pts, masks, cfg, k, init=None):
    init = None if init is None else torch.from_numpy(init)
    g = tocc.build_logodds(torch.from_numpy(poses), torch.from_numpy(pts),
                           torch.from_numpy(masks), cfg, k, init=init)
    assert g.dtype == torch.float32 and g.shape == (cfg.width, cfg.height)
    return g.numpy()


def test_world2grid_and_ray_ends_match_jax():
    poses, pts, _ = _adversarial_scans(seed=1)
    ends = tocc.ray_ends(torch.from_numpy(poses), torch.from_numpy(pts),
                         TCFG).numpy()
    # the JAX closed form inline in ray_descriptors, per scan
    for s in range(poses.shape[0]):
        x, y, yaw = poses[s]
        wx = jnp.asarray(pts[s, :, 0]) * jnp.cos(yaw) \
            - jnp.asarray(pts[s, :, 1]) * jnp.sin(yaw) + x
        wy = jnp.asarray(pts[s, :, 0]) * jnp.sin(yaw) \
            + jnp.asarray(pts[s, :, 1]) * jnp.cos(yaw) + y
        ex, ey = jocc.world2grid(wx, wy, JCFG)
        np.testing.assert_array_equal(ends[s, :, 2], np.asarray(ex))
        np.testing.assert_array_equal(ends[s, :, 3], np.asarray(ey))
    xs = torch.tensor([-6.0, -5.95, -5.9, 0.0, 0.05, 5.99, 6.0, 7.3])
    ti, tj = tocc.world2grid(xs, -xs, TCFG)
    ji, jj = jocc.world2grid(jnp.asarray(xs.numpy()),
                             jnp.asarray(-xs.numpy()), JCFG)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))


@pytest.mark.parametrize("seed", [0, 1])
def test_ray_descriptors_match_jax(seed):
    """The integer contract of the ray walk: (steep, sM, sm, sgM, sgm, dM,
    dm, c, k_in, k_out) equal per ray, including skipped rays."""
    poses, pts, masks = _adversarial_scans(seed=seed, n=4, r=256)
    ends = tocc.ray_ends(torch.from_numpy(poses), torch.from_numpy(pts), TCFG)
    walked = skipped = 0
    for s in range(poses.shape[0]):
        want = j_descriptors(jnp.asarray(poses[s]), jnp.asarray(pts[s]),
                             jnp.asarray(masks[s]), JCFG, K)
        got = ray_descriptors(ends[s], torch.from_numpy(masks[s]), TCFG, K)
        for name, g, w in zip("steep sM sm sgM sgm dM dm c k_in k_out".split(),
                              got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"scan {s} {name}")
        walked += int((got[-2] <= got[-1]).sum())
        skipped += int((got[-2] > got[-1]).sum())
    assert walked > 500 and skipped > 50


def test_bresenham_matches_jax():
    rng = np.random.default_rng(3)
    e = rng.integers(-40, 40, (4, 300)).astype(np.int32)
    e[:, :4] = [[0, 0, 5, -7], [0, 0, 0, 0], [0, 0, -9, 3], [0, 0, 6, 6]]
    want = j_bresenham(*map(jnp.asarray, e), 64)
    got = bresenham_fixed(*map(torch.from_numpy, e), 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_build_matches_jax_scatter_adversarial():
    poses, pts, masks = _adversarial_scans()
    want = _jax_map(poses, pts, masks, JCFG, K)
    got = _port_map(poses, pts, masks, TCFG, K)
    np.testing.assert_array_equal(got, want)
    assert (want != 0).sum() > 1000
    np.testing.assert_array_equal(tocc.finalize_grid(torch.from_numpy(got)),
                                  np.asarray(jocc.finalize_grid(want)))


def test_build_with_init_grid_matches_jax():
    """A constant init grid against the JAX scatter path, a random one
    against the JAX per-scan ray-walk kernel (v8). Both port engines add in
    ray order; the JAX scatter path adds in ray-LENGTH order
    (_compact_scan_update sorts rays), which on a random init grid rounds
    differently in the last bit, so only ray-order engines are its
    bit-exact reference there."""
    poses, pts, masks = _adversarial_scans(seed=5, n=3, r=32)
    init = np.full((TCFG.width, TCFG.height), 2.5, np.float32)
    want = _jax_map(poses, pts, masks, JCFG, K, init=init)
    np.testing.assert_array_equal(
        _port_map(poses, pts, masks, TCFG, K, init=init), want)

    init = np.random.default_rng(5).normal(
        0, 1, (TCFG.width, TCFG.height)).astype(np.float32)
    keep = init.copy()
    want = _jax_map(poses, pts, masks, JCFG, K, init=init, version=8)
    np.testing.assert_array_equal(
        _port_map(poses, pts, masks, TCFG, K, init=init), want)
    np.testing.assert_array_equal(init, keep)  # read, not written


def test_clip_applied_per_scan():
    """tests/test_occupancy.py: one cell observed 40 times saturates at the
    clip, applied after every scan."""
    geom = dict(resolution=0.5, world_max_x=3, world_min_x=-3,
                world_max_y=3, world_min_y=-3)
    n = 40
    poses = np.zeros((n, 3), np.float32)
    pts = np.tile(np.array([[[1.0, 0.0]]], np.float32), (n, 1, 1))
    masks = np.ones((n, 1), bool)
    k = tocc.max_ray_cells(MapConfig(**geom), 4.0)
    want = _jax_map(poses, pts, masks, JMapConfig(**geom), k)
    got = _port_map(poses, pts, masks, MapConfig(**geom), k)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 20.0 and got.min() == -20.0


@pytest.mark.parametrize("version", [1, 2, 3, 7, 8, 11])
def test_build_matches_every_jax_raywalk_version(version):
    """The one port ray-walk family against each JAX kernel generation
    (Pallas interpret mode) at a tiny size."""
    poses, pts, masks = _adversarial_scans(seed=7, n=4, r=48)
    want = _jax_map(poses, pts, masks, JCFG, K, version=version)
    got = _port_map(poses, pts, masks, TCFG, K)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).sum() > 300


def test_large_k_matches_jax_v1_fallback():
    """K = 768 is past the v2+ visit capacity, where the JAX package falls
    back to the v1 kernel; the port has no capacity limit."""
    geom = dict(resolution=0.025, world_max_x=10, world_min_x=-10,
                world_max_y=10, world_min_y=-10)
    k = 768
    rng = np.random.default_rng(9)
    n, r = 3, 48
    ang = rng.uniform(-np.pi, np.pi, (n, r))
    dist = rng.uniform(1.0, 19.0, (n, r))
    pts = np.stack([dist * np.cos(ang), dist * np.sin(ang)],
                   axis=-1).astype(np.float32)
    masks = np.ones((n, r), bool)
    poses = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    want = _jax_map(poses, pts, masks, JMapConfig(**geom), k, version=1)
    got = _port_map(poses, pts, masks, MapConfig(**geom), k)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).sum() > 1000


def test_ray_cell_bounds_and_finalize_match_jax():
    poses, pts, masks = _adversarial_scans(seed=2)
    assert tocc.max_ray_cells(TCFG, 9.0) == jocc.max_ray_cells(JCFG, 9.0)
    assert (tocc.adaptive_ray_cells(torch.from_numpy(pts),
                                    torch.from_numpy(masks), TCFG, 9.0)
            == jocc.adaptive_ray_cells(pts, masks, JCFG, 9.0))
    assert tocc.adaptive_ray_cells(torch.from_numpy(pts),
                                   torch.zeros(masks.shape, dtype=torch.bool),
                                   TCFG) == 64
    lo = np.array([[-5.0, -1e-7, 0.0, 1e-7, 5.0, 20.0, -20.0]], np.float32)
    np.testing.assert_array_equal(
        tocc.finalize_grid(torch.from_numpy(lo)).numpy(),
        np.asarray(jocc.finalize_grid(jnp.asarray(lo))))


def test_backend_dispatch_on_cpu():
    poses, pts, masks = _adversarial_scans(seed=3, n=3, r=32)
    args = (torch.from_numpy(poses), torch.from_numpy(pts),
            torch.from_numpy(masks), TCFG, K)
    before = raywalk_build.launches
    auto = tocc.build_logodds(*args)
    scatter = tocc.build_logodds_scatter(tocc.ray_ends(*args[:2], TCFG),
                                         args[2], TCFG, K)
    assert torch.equal(auto, scatter)
    assert raywalk_build.launches == before  # CPU tensors never launch
    with pytest.raises(RuntimeError, match="CUDA"):
        tocc.build_logodds(*args, backend="cuda")
    with pytest.raises(ValueError, match="unknown map backend"):
        tocc.build_logodds(*args, backend="raywalk")
