"""Parity of the port's banded Levenberg-Marquardt pose-graph solve with the
JAX package, on a fixed-interval graph built from the JAX package's own
scan-matching and loop-closure output.

Tolerances: LM iteration counts equal, poses within 2e-5, final cost
within 1e-6 relative. The float32 case runs the JAX side under
jax.enable_x64(False).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_slam_tpu.config import LidarConfig, PoseGraphConfig as JPGC
from lidar_slam_tpu.models import pose_graph as jpg
from lidar_slam_tpu.models import scan_matching as jsm
from lidar_slam_tpu.models import slam as jslam
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.utils import io as jio

from lidar_slam_tpu_torch.config import PoseGraphConfig as TPGC
from lidar_slam_tpu_torch.models import pose_graph as tpg
from lidar_slam_tpu_torch.utils import interop

torch.set_num_threads(1)

INTERVAL = 10


@pytest.fixture(scope="module")
def graph_inputs():
    """Scan matching + fixed-interval loop ICPs of a 90-step synthetic log,
    from the JAX package in float64 (numpy arrays)."""
    d = jio.synthetic_dataset(n_steps=90, n_rays=181, seed=3)
    pts, masks = jscan.scans_to_points(jnp.asarray(d["lidar"]["ranges"]),
                                       0.1, 30.0, LidarConfig(n_rays=181))
    odo = jnp.asarray(d["ground_truth"]
                      + np.random.default_rng(0).normal(0, 0.02, (90, 3)))
    sm = jsm.poses_from_scan_matching(odo, pts, masks, chunk_size=16)
    cand = jslam.loop_closure_candidates(90, INTERVAL)
    loop_T, accept, _, _ = jslam.compute_loop_closures(
        jicp.lift_to_3d(pts), masks, cand, INTERVAL, 1.0, 30.0,
        chunk_size=16)
    # start LM away from the optimum so it takes several steps
    poses0 = np.asarray(sm.poses) + np.random.default_rng(1).normal(
        0, 0.05, (90, 3))
    return dict(poses0=poses0, rel=np.asarray(sm.relative_poses),
                loop_i=cand, loop_j=cand + INTERVAL,
                loop_T=np.asarray(loop_T), accept=np.asarray(accept))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_banded_lm_matches_jax(graph_inputs, dtype):
    g = graph_inputs
    npd, tdt = ((np.float64, torch.float64) if dtype == "f64"
                else (np.float32, torch.float32))
    assert g["accept"].sum() >= 3  # real loop factors in the graph
    kw = dict(solver="banded", fixed_interval=INTERVAL)
    arrays = (g["poses0"].astype(npd), g["rel"].astype(npd), g["loop_i"],
              g["loop_j"], g["loop_T"].astype(npd), g["accept"])
    with jax.enable_x64(dtype == "f64"):
        jr = jpg.optimize_trajectory(*map(jnp.asarray, arrays), JPGC(**kw))
        j_poses, j_cost, j_it = (np.asarray(jr.poses), float(jr.cost),
                                 int(jr.iterations))
    tr = tpg.optimize_trajectory(*interop.from_numpy(arrays), TPGC(**kw))
    assert tr.poses.dtype == tdt
    assert tr.iterations == j_it and j_it >= 3
    np.testing.assert_allclose(tr.poses.numpy(), j_poses, rtol=0, atol=2e-5)
    assert abs(float(tr.cost) - j_cost) <= 1e-6 * abs(j_cost)


def test_residuals_and_cost_match_jax(graph_inputs):
    g = graph_inputs
    kw = dict(loop_i=g["loop_i"], loop_j=g["loop_j"], loop_meas=g["loop_T"],
              loop_mask=g["accept"])
    jg = jpg.make_graph(jnp.asarray(g["rel"]), JPGC(),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tg = tpg.make_graph(interop.from_numpy(g["rel"]), TPGC(),
                        **interop.from_numpy(kw))
    x = g["poses0"]
    np.testing.assert_allclose(
        tpg.residuals(torch.from_numpy(x), tg).numpy(),
        np.asarray(jpg.residuals(jnp.asarray(x), jg)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        float(tpg.graph_cost(torch.from_numpy(x), tg)),
        float(jpg.graph_cost(jnp.asarray(x), jg)), rtol=1e-12)


@pytest.mark.parametrize("n,b,q", [(9, 3, 64), (150, 3, 8), (77, 6, 8)])
def test_block_tridiag_solve_matches_jax(n, b, q):
    """Thomas (n <= 2q) and the two-level SPIKE split (n > 2q, ragged
    last segment) against the JAX solver and a dense solve."""
    rng = np.random.default_rng(n)
    O = rng.normal(0, 0.3, (n - 1, b, b))
    A = np.stack([np.eye(b) * (4.0 + b) + 0.1 * (m + m.T)
                  for m in rng.normal(size=(n, b, b))])
    R = rng.normal(size=(n, b, 2))
    want = np.asarray(jpg.block_tridiag_solve(jnp.asarray(A), jnp.asarray(O),
                                              jnp.asarray(R), q=q))
    got = tpg.block_tridiag_solve(torch.from_numpy(A), torch.from_numpy(O),
                                  torch.from_numpy(R), q=q).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    dense = np.zeros((n * b, n * b))
    for i in range(n):
        dense[i * b:(i + 1) * b, i * b:(i + 1) * b] = A[i]
    for i in range(n - 1):
        dense[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = O[i]
        dense[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = O[i].T
    x = np.linalg.solve(dense, R.reshape(n * b, 2)).reshape(n, b, 2)
    np.testing.assert_allclose(got, x, rtol=0, atol=1e-10)


def test_jacobians_keep_float32():
    """torch.func.jacfwd of the SE(2) log map keeps float32 Jacobian
    blocks float32 (jacfwd promotes a 0-d float32 tensor divided by a
    Python float to a float64 tangent)."""
    p = torch.tensor([[0.1, -0.2, 0.3], [1.0, 2.0, 1e-9]])
    m = torch.eye(3).expand(2, 3, 3)
    r, Ji, Jj = tpg._factor_r_and_J(p, p.flip(0), m, torch.ones(3))
    assert r.dtype == Ji.dtype == Jj.dtype == torch.float32


def test_unported_solvers_and_wide_loops_raise():
    rel = torch.eye(3, dtype=torch.float64).expand(30, 3, 3)
    poses = torch.zeros((31, 3), dtype=torch.float64)
    li, lj = torch.tensor([0, 5]), torch.tensor([10, 27])
    meas = torch.eye(3, dtype=torch.float64).expand(2, 3, 3)
    cfg = TPGC(solver="banded", fixed_interval=10)
    with pytest.raises(ValueError, match="banded"):
        tpg.optimize_trajectory(poses, rel, li, lj, meas,
                                torch.tensor([True, True]), cfg)
    # a rejected wide loop carries no weight and is allowed
    res = tpg.optimize_trajectory(poses, rel, li, lj, meas,
                                  torch.tensor([True, False]), cfg)
    assert torch.isfinite(res.poses).all()
    for bad in (dict(solver="direct"), dict(solver="cg"),
                dict(robust_loss="huber")):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tpg.optimize_trajectory(poses, rel, li, lj, meas,
                                    torch.tensor([True, False]),
                                    dataclasses.replace(cfg, **bad))
