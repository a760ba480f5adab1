"""The port's fused multi-rank SLAM step and dry run, on the CPU.

One module-scoped fixture spawns 4 gloo ranks once on a (2, 2) ("dp",
"rp") mesh (tests/torch_parallel_ranks.superstep_cases). Each window goes
through parallel/superstep.make_slam_step and is held against the
unsharded composition of the same stages at the same caps in the port, as
tests/test_superstep_goldens.py holds JAX's step (poses and ICP errors
within 1e-6, log-odds within 1e-4, finalized grids equal), and against
JAX's make_slam_step on its (2, 2) mesh of the 8-device CPU mesh fed the
same numpy inputs. Port and JAX differ there by float32 rounding of the
ICP fits (the Kabsch sums reduce in other orders; ROADMAP Queue 3), so
the poses are held to JAX's within 1e-5, the float32 transform bound of
tests/test_torch_ops.py::test_run_icp_batch_matches_jax, and the maps
within 1e-4 with equal finalized grids. The "window" case pads its 7
pairs to 8 on the 2-way "dp" axis; "carried" starts from a nonzero map.
dryrun_multichip(4, device="cpu") runs in ranks of its own.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models.occupancy import max_ray_cells as jmax_ray_cells
from lidar_slam_tpu.parallel import mesh as jmesh
from lidar_slam_tpu.parallel import superstep as jss

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.models import pose_graph as tpg
from lidar_slam_tpu_torch.ops.icp import run_icp_batch
from lidar_slam_tpu_torch.parallel import dryrun, launch
from lidar_slam_tpu_torch.utils import se2

import torch_parallel_ranks

torch.set_num_threads(1)

SHARDED_TOL, JAX_POSE_TOL, MAP_TOL = 1e-6, 1e-5, 1e-4
MAP = dict(resolution=0.2, world_max_x=6, world_min_x=-6, world_max_y=6,
           world_min_y=-6)
ICP = dict(max_iters=64)
PG = dict(max_lm_iters=3, cg_iters=25)
T = torch.from_numpy


def _window(seed, N, R, carried):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    points = np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros_like(r)],
                      -1).astype(np.float32)
    cfg = tc.MapConfig(**MAP)
    logodds = np.zeros((cfg.width, cfg.height), np.float32)
    if carried:
        logodds = np.clip(rng.normal(0, 3.0, logodds.shape), -20,
                          20).astype(np.float32)
    return dict(points=points, masks=rng.random((N, R)) > 0.05,
                odom=np.cumsum(rng.normal(0, 0.02, (N, 3)),
                               axis=0).astype(np.float32),
                logodds=logodds, icp=ICP, pg=PG)


@pytest.fixture(scope="module")
def inputs():
    return dict(cfg=MAP, K=tocc.max_ray_cells(tc.MapConfig(**MAP), 6.0),
                cases={"window": _window(3, 8, 32, False),
                       "carried": _window(4, 7, 32, True)})


@pytest.fixture(scope="module")
def ranked(inputs):
    return launch.run_ranks(torch_parallel_ranks.superstep_cases, 4, None,
                            "cpu", inputs)


def _unsharded(c, K):
    """The port's single-device composition of the step's stages."""
    cfg = tc.MapConfig(**MAP)
    pg_cfg = tc.PoseGraphConfig(**PG)
    points, masks, odom = T(c["points"]), T(c["masks"]), T(c["odom"])
    seeds3 = se2.TSE3_from_TSE2(se2.get_relative_pose(odom[:-1], odom[1:]))
    icp = tc.IcpConfig(**ICP)
    res = run_icp_batch(points[1:], points[:-1], masks[1:], masks[:-1],
                        seeds3, epsilon=icp.epsilon, max_iters=icp.max_iters,
                        stopping_thresh=icp.stopping_thresh, planar=True)
    rel2 = se2.TSE2_from_TSE3(res.T)
    poses0 = se2.pose_from_T(se2.compose_chain(rel2,
                                               se2.T_from_pose(odom[0])))
    graph = tpg.make_graph(rel2, pg_cfg, prior_pose=odom[0])
    opt = tpg.optimize(poses0, graph, max_iters=pg_cfg.max_lm_iters,
                       cg_iters=pg_cfg.cg_iters,
                       lambda_init=pg_cfg.lambda_init,
                       lambda_up=pg_cfg.lambda_up,
                       lambda_down=pg_cfg.lambda_down,
                       solver=pg_cfg.solver)
    grid = tocc.build_logodds(opt.poses, points[..., :2], masks, cfg, K,
                              init=T(c["logodds"]))
    return opt.poses, res.error, grid


def _jax_step(c, K):
    mesh = jmesh.make_mesh(4, axes=("dp", "rp"))
    step = jss.make_slam_step(mesh, jc.MapConfig(**MAP), K,
                              jc.IcpConfig(**ICP), jc.PoseGraphConfig(**PG))
    return step(*(jnp.asarray(c[k]) for k in ("points", "masks", "odom",
                                              "logodds")))


def _assert_maps(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MAP_TOL,
                               rtol=0)
    np.testing.assert_array_equal(
        tocc.finalize_grid(got).numpy(),
        tocc.finalize_grid(torch.as_tensor(np.asarray(want))).numpy())


@pytest.mark.parametrize("case", ["window", "carried"])
def test_superstep_matches_unsharded(inputs, ranked, case):
    assert ranked["mesh"] == {"dp": 2, "rp": 2}
    c = inputs["cases"][case]
    got = ranked[case]
    poses, errors, grid = _unsharded(c, inputs["K"])
    N = c["points"].shape[0]
    assert got.poses.shape == (N, 3) and got.icp_errors.shape == (N - 1,)
    np.testing.assert_allclose(got.poses.numpy(), poses.numpy(),
                               atol=SHARDED_TOL, rtol=0)
    np.testing.assert_allclose(got.icp_errors.numpy(), errors.numpy(),
                               atol=SHARDED_TOL, rtol=0)
    _assert_maps(got.logodds, grid)
    assert int((got.logodds != T(c["logodds"])).sum()) > 100


@pytest.mark.parametrize("case", ["window", "carried"])
def test_superstep_matches_jax(inputs, ranked, case):
    c = inputs["cases"][case]
    got = ranked[case]
    want = _jax_step(c, jmax_ray_cells(jc.MapConfig(**MAP), 6.0))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=JAX_POSE_TOL, rtol=0)
    np.testing.assert_allclose(got.icp_errors.numpy(),
                               np.asarray(want.icp_errors),
                               atol=JAX_POSE_TOL, rtol=0)
    np.testing.assert_allclose(float(got.graph_cost),
                               float(want.graph_cost), rtol=1e-4, atol=1e-9)
    _assert_maps(got.logodds, want.logodds)


def test_superstep_cuda_backend_needs_cuda_tensors(ranked):
    assert "needs CUDA tensors" in ranked["cuda_backend"]


def test_dryrun_multichip_on_cpu(capsys):
    """__graft_entry__.dryrun_multichip's counterpart on 4 CPU ranks: one
    superstep on the (2, 2) mesh, both paints equal to their sequential
    versions, and its summary printed."""
    s = dryrun.dryrun_multichip(4, device="cpu")
    assert s["mesh"] == {"dp": 2, "rp": 2} and s["backend"] == "gloo"
    assert s["poses"] == (8, 3) and s["map"] == (61, 61)
    assert s["cells_painted"] > 0 and s["op_cells_painted"] > 0
    assert s["collectives"] > 0
    assert "dryrun_multichip OK on 4 ranks" in capsys.readouterr().out


def test_run_ranks_reraises_a_rank_error():
    """A rank's exception comes back to the caller with its type."""
    with pytest.raises(ValueError, match="banded-only"):
        launch.run_ranks(torch_parallel_ranks.raise_on_rank, 2, None, "cpu",
                         1)


def test_multichip_scaling_rank_program_on_cpu():
    """tools/multichip_scaling's rank program on 2 CPU ranks at a small
    size: both builders within 1e-4 of raywalk_build's plain version, one
    psum a scan for the rays split, one gather for the scans split."""
    from lidar_slam_tpu_torch.tools import multichip_scaling

    out = multichip_scaling.run(8, (2,), "cpu", dict(
        resolution=0.25, world_max_x=15, world_min_x=-15, world_max_y=15,
        world_min_y=-15), log=lambda m: None)[2]
    assert out["backend"] == "gloo"
    rays, scans = out["rows"]["rays"], out["rows"]["scans"]
    assert rays["collectives"] == 8 and scans["collectives"] == 1
    assert scans["scans_walked"] == 4 and rays["scans_walked"] == 8
    assert max(rays["max_abs_diff"], scans["max_abs_diff"]) <= MAP_TOL
