"""The port's host utilities against the JAX package's, on the CPU.

world2grid (the cell function every map, score and search uses), the
grid2world inverse, the OccupancyGridMap wrapper (maps within the online
path's 1e-4 with equal hit maps; grid_map, cell lookups and PNGs equal),
the trajectory and scan plots (the rasterizer's PNG byte for byte), the
StageLogger (the same lines, the clock pinned), and the kidnapped-robot log
(utils/io.kidnap_log) against the JAX tests' own, bit for bit.
"""

import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import occupancy as jocc
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.utils import io as jio
from lidar_slam_tpu.utils import logging as jlog
from lidar_slam_tpu.utils import plotting as jplot

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.utils import io as tio
from lidar_slam_tpu_torch.utils import logging as tlog
from lidar_slam_tpu_torch.utils import plotting as tplot

torch.set_num_threads(1)

MAP_TOL = 1e-4


@pytest.mark.parametrize("res", [0.05, 0.1, 0.03, 0.25])
def test_world2grid_equals_jax(res):
    """The JAX package's world2grid under jit (every caller of it is
    jitted) is ceil((x - min) * (1/res)) - 1: XLA turns the division by the
    constant res into a product by its float32 reciprocal. The port computes
    that product, and the cells are equal on 200,000 random points and on
    points within 3 float32 steps of every boundary, where a true division
    differs unless 1/res is exact."""
    jm, tm = jc.MapConfig(resolution=res), tc.MapConfig(resolution=res)
    rng = np.random.default_rng(0)
    # random points, and points within 3 float32 steps of every boundary
    edges = (tm.world_min_x + np.arange(tm.width) * res).astype(np.float32)
    near = np.concatenate([edges] + [
        np.nextafter(edges, np.float32(d * np.inf)) for d in (-1, 1)]
        + [edges + np.float32(k) * np.spacing(edges)
           for k in (-3, -2, 2, 3)])
    x = np.concatenate([rng.uniform(-31, 31, 200_000).astype(np.float32),
                        near])
    y = np.concatenate([near, rng.uniform(-31, 31, 200_000).astype(
        np.float32)])
    ji, jj = (np.asarray(a) for a in jax.jit(
        lambda a, b: jocc.world2grid(a, b, jm))(jnp.asarray(x),
                                                jnp.asarray(y)))
    ti, tj = (a.numpy() for a in tocc.world2grid(torch.as_tensor(x),
                                                 torch.as_tensor(y), tm))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)
    div = (np.ceil((x - np.float32(tm.world_min_x)) / np.float32(res))
           .astype(np.int32) - 1)
    assert (div != ji).any() == (res != 0.25)  # 1/0.25 is exact


def test_grid2world_equals_jax():
    m = tc.MapConfig(resolution=0.05)
    i = torch.arange(-3, 1205, dtype=torch.int32)
    x, y = tocc.grid2world(i, i.flip(0), m)
    assert x.dtype == torch.float32
    jx, jy = jocc.grid2world(jnp.asarray(i.numpy()),
                             jnp.asarray(i.flip(0).numpy()),
                             jc.MapConfig(resolution=0.05))
    # JAX returns float64 under x64, the port float32: within its rounding
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    gi, gj = tocc.world2grid(x + 0.025, y + 0.025, m)
    assert torch.equal(gi, i) and torch.equal(gj, i.flip(0))


def test_occupancy_grid_map_equals_jax(tmp_path):
    """The reference class surface: create, two update_map calls (a mask
    and none), a build_map on top, the cell lookups and both PNGs."""
    d = jio.synthetic_dataset(n_steps=12, n_rays=181, seed=4)
    gt = np.asarray(d["ground_truth"], np.float32)
    pts, masks = jscan.scans_to_points(
        jnp.asarray(d["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
        jc.LidarConfig())
    pts, masks = np.array(pts, np.float32)[..., :2], np.array(masks)
    kw = dict(resolution=0.1, world_map_max_x=12.0, world_map_max_y=12.0,
              world_map_min_x=-12.0, world_map_min_y=-12.0)
    jg = jocc.OccupancyGridMap.create(**kw)
    tg = tocc.OccupancyGridMap.create(**kw, device="cpu")
    assert (tg.grid_map_width, tg.grid_map_height, tg.K) == (
        jg.grid_map_width, jg.grid_map_height, jg.K)
    for g in (jg, tg):
        g.update_map(gt[0], pts[0], masks[0])
        g.update_map(gt[1], pts[1])
        g.build_map(gt[2:], pts[2:], masks[2:])
    lo_j, lo_t = np.asarray(jg.grid_map_log_odds), tg.grid_map_log_odds
    assert isinstance(lo_t, torch.Tensor)
    np.testing.assert_allclose(lo_t.numpy(), lo_j, atol=MAP_TOL)
    np.testing.assert_array_equal(lo_t.numpy() > 0, lo_j > 0)
    np.testing.assert_array_equal(tg.grid_map, jg.grid_map)
    assert int((lo_j != 0).sum()) > 1000
    xs, ys = [0.0, 3.3, -7.25], [1.0, -2.2, 11.9]
    np.testing.assert_array_equal(tg.world2grid(xs, ys), jg.world2grid(
        np.asarray(xs, np.float32), np.asarray(ys, np.float32)))
    np.testing.assert_allclose(tg.grid2world([0, 5, 240], [3, 7, 9]),
                               jg.grid2world([0, 5, 240], [3, 7, 9]),
                               rtol=0, atol=1e-5)
    for name in ("plot_map", "plot_log_odds_map"):
        getattr(jg, name)(str(tmp_path / f"j_{name}.png"))
        getattr(tg, name)(str(tmp_path / f"t_{name}.png"))
        assert ((tmp_path / f"t_{name}.png").read_bytes()
                == (tmp_path / f"j_{name}.png").read_bytes())


def test_raster_plots_equal_jax(tmp_path, monkeypatch):
    """Without matplotlib both packages rasterize with their Bresenham:
    the PNGs are equal byte for byte (two trajectories, then one scan)."""
    for mod in (jplot, tplot):
        monkeypatch.setattr(mod, "_have_matplotlib", lambda: False)
    rng = np.random.default_rng(5)
    a = np.cumsum(rng.normal(0, 0.1, (60, 3)), axis=0)
    b = a + np.array([0.5, -0.3, 0.0])
    for mod, tag in ((jplot, "j"), (tplot, "t")):
        mod.plot_trajectories([a, b], str(tmp_path / tag / "traj.png"))
        mod.view_lidar_points(a[:, :2], str(tmp_path / tag / "scan.png"))
    for name in ("traj.png", "scan.png"):
        data = (tmp_path / "t" / name).read_bytes()
        assert data == (tmp_path / "j" / name).read_bytes() and len(data)


def test_matplotlib_plots_write(tmp_path):
    """With matplotlib (when importable) both functions write a PNG."""
    pytest.importorskip("matplotlib")
    a = np.cumsum(np.ones((10, 3)) * 0.1, axis=0)
    tplot.plot_trajectories([a, a + 1.0], str(tmp_path / "p" / "t.png"),
                            labels=["a", "b"], title="T")
    tplot.view_lidar_points(a[:, :2], str(tmp_path / "p" / "s.png"))
    for name in ("t.png", "s.png"):
        assert (tmp_path / "p" / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("json_lines", [False, True])
def test_stage_logger_equals_jax(json_lines, monkeypatch):
    outs = []
    for mod in (jlog, tlog):
        clock = iter([100.0, 101.25, 200.0, 200.5])
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        buf = io.StringIO()
        lg = mod.StageLogger(stream=buf, json_lines=json_lines)
        lg.banner("run")
        lg.start("odometry")
        lg.metric("steps", 12)
        lg.metric("err_m", 0.125)
        lg.end()
        lg.start("map")
        lg.metric("cells", 4096)
        lg.end()
        lg.metric("free", True)
        outs.append((buf.getvalue(), lg.summary()))
    assert outs[0] == outs[1]
    assert outs[1][1]["odometry.seconds"] == 1.25
    if json_lines:
        json.loads(outs[1][0].strip().splitlines()[-1])


@pytest.mark.parametrize("sizes", [dict(), dict(n=160, t_kidnap=120,
                                                t_target=30)])
def test_kidnap_log_equals_jax_tests(sizes):
    """utils/io.kidnap_log, which the port's tests and chip_smoke.py run,
    is tests/test_online.py::_kidnap_log: counts, gyro, ranges and ground
    truth equal bit for bit, at the JAX test's sizes and the reduced ones."""
    from test_online import _kidnap_log

    for a, b in zip(tio.kidnap_log(**sizes), _kidnap_log(**sizes)):
        np.testing.assert_array_equal(a, b)
