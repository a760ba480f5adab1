"""The plain reference agrees with the program on small logs on the CPU:
whole runs of each cell through the harness come out correct, and the
reference's pieces equal the program's where both are exact."""

import pytest
import torch

from bench_paths import harness, tiny_cell, cpu_run
from reference import mapping as rmap
from reference import geometry as geo

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_a_small_log(name):
    res = cpu_run(tiny_cell(name))
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1
    assert list(res)[-1] == "compared"
    for c in res["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_on_a_small_log(name):
    res = cpu_run(tiny_cell(name), trace=True)
    assert res["correct"], res["compared"]
    assert "breakdown" in res


def test_bresenham_equals_the_programs_rays():
    from lidar_slam_tpu_torch.ops.bresenham import bresenham_fixed

    g = torch.Generator().manual_seed(3)
    sx, sy, ex, ey = (torch.randint(-40, 240, (5000,), generator=g)
                      for _ in range(4))
    xs, ys, m = rmap.bresenham(sx, sy, ex, ey, 300)
    xp, yp, mp = bresenham_fixed(sx.int(), sy.int(), ex.int(), ey.int(), 300)
    assert torch.equal(m, mp)
    assert torch.equal(xs[m], xp[mp].long())
    assert torch.equal(ys[m], yp[mp].long())


def test_map_equals_the_programs_plain_map():
    from lidar_slam_tpu_torch.config import MapConfig
    from lidar_slam_tpu_torch.models import occupancy

    cfg = MapConfig(resolution=0.2, world_min_x=-8, world_max_x=8,
                    world_min_y=-8, world_max_y=8)
    g = torch.Generator().manual_seed(5)
    poses = torch.rand(6, 3, generator=g, dtype=torch.float64) * 4 - 2
    pts = torch.rand(6, 50, 2, generator=g, dtype=torch.float64) * 12 - 6
    masks = torch.rand(6, 50, generator=g) > 0.1
    m = {"width": cfg.width, "height": cfg.height, "resolution": 0.2,
         "world_min_x": -8.0, "world_min_y": -8.0, "logodds_clip": 20.0}
    ref = rmap.build(poses, pts, masks, m, (0.13323, 0.0))
    K = occupancy.max_ray_cells(cfg, 12.0)
    prog = occupancy.build_logodds(poses.float(), pts.float(), masks, cfg, K)
    assert (ref - prog.double()).abs().max() < 1e-4


def test_odometry_equals_the_programs():
    from lidar_slam_tpu_torch.models.odometry import poses_from_odometry

    g = torch.Generator().manual_seed(9)
    counts = torch.rand(200, 4, generator=g, dtype=torch.float64) * 5
    gyro = torch.rand(200, 3, generator=g, dtype=torch.float64) - 0.5
    ref = geo.odometry(counts.numpy(), gyro.numpy(), 0.0022, 40.0)
    prog = poses_from_odometry(counts, gyro)
    assert abs(ref - prog.numpy()).max() < 1e-9
