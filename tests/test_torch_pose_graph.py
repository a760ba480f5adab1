"""Parity of the port's Levenberg-Marquardt pose-graph solve with the JAX
package: the banded, direct (SPIKE + Woodbury) and CG solvers on a
fixed-interval graph built from the JAX package's own scan-matching and
loop-closure output, the robust kernels on tests/test_pose_graph_robust.py's
outlier world, and the banded solver's fallback to direct on
tests/test_pose_graph.py's interval graphs.

Tolerances: LM iteration counts equal, poses within 2e-5, final cost
within 1e-6 relative (CG in float32: poses 1e-4, cost 1e-5, its inner
iterations stopping on float32 residual norms). The float32 cases run the
JAX side under jax.enable_x64(False).
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
    """Every solver and robust kernel runs now: a live loop wider than the
    band no longer raises but falls back to the direct solver (bit-equal
    to it), a rejected wide loop keeps the banded solve, and an unknown
    solver or kernel raises ValueError (the JAX text for the kernel)."""
    rel = torch.eye(3, dtype=torch.float64).expand(30, 3, 3)
    poses = torch.zeros((31, 3), dtype=torch.float64)
    li, lj = torch.tensor([0, 5]), torch.tensor([10, 27])
    meas = torch.eye(3, dtype=torch.float64).expand(2, 3, 3)
    cfg = TPGC(solver="banded", fixed_interval=10)
    both = torch.tensor([True, True])
    fell = tpg.optimize_trajectory(poses, rel, li, lj, meas, both, cfg)
    direct = tpg.optimize_trajectory(poses, rel, li, lj, meas, both,
                                     dataclasses.replace(cfg,
                                                         solver="direct"))
    assert torch.equal(fell.poses, direct.poses)
    res = tpg.optimize_trajectory(poses, rel, li, lj, meas,
                                  torch.tensor([True, False]), cfg)
    assert torch.isfinite(res.poses).all()
    for ok in (dict(solver="cg"), dict(robust_loss="huber"),
               dict(robust_loss="cauchy")):
        res = tpg.optimize_trajectory(poses, rel, li, lj, meas, both,
                                      dataclasses.replace(cfg, **ok))
        assert torch.isfinite(res.poses).all()
    with pytest.raises(ValueError, match="unknown pose-graph solver"):
        tpg.optimize_trajectory(poses, rel, li, lj, meas, both,
                                dataclasses.replace(cfg, solver="qr"))
    with pytest.raises(ValueError, match="unknown robust kernel 'tukey'"):
        tpg.optimize_trajectory(poses, rel, li, lj, meas, both,
                                dataclasses.replace(cfg,
                                                    robust_loss="tukey"))


@pytest.mark.parametrize("solver,dtype", [("direct", "f64"),
                                          ("direct", "f32"), ("cg", "f64"),
                                          ("cg", "f32")])
def test_direct_and_cg_lm_match_jax(graph_inputs, solver, dtype):
    """The direct (SPIKE + Woodbury) and CG solvers against JAX's on the
    fixed-interval graph, every loop candidate in the Woodbury panel."""
    g = graph_inputs
    npd = np.float64 if dtype == "f64" else np.float32
    kw = dict(solver=solver, fixed_interval=INTERVAL)
    arrays = (g["poses0"].astype(npd), g["rel"].astype(npd), g["loop_i"],
              g["loop_j"], g["loop_T"].astype(npd), g["accept"])
    with jax.enable_x64(dtype == "f64"):
        jr = jpg.optimize_trajectory(*map(jnp.asarray, arrays), JPGC(**kw))
        j_poses, j_cost, j_it = (np.asarray(jr.poses), float(jr.cost),
                                 int(jr.iterations))
    tr = tpg.optimize_trajectory(*interop.from_numpy(arrays), TPGC(**kw))
    loose = solver == "cg" and dtype == "f32"
    assert tr.iterations == j_it and j_it >= 3
    np.testing.assert_allclose(tr.poses.numpy(), j_poses, rtol=0,
                               atol=1e-4 if loose else 2e-5)
    assert abs(float(tr.cost) - j_cost) <= (1e-5 if loose else 1e-6) * abs(
        j_cost)


def _interval_graph(rng, n, G, span_mode):
    """tests/test_pose_graph.py::_interval_graph as numpy arrays: a
    drifting trajectory, noisy relative measurements, loops of span <= G."""
    from lidar_slam_tpu.utils import se2 as jse2

    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    rel = jse2.get_relative_pose(jnp.asarray(gt[:-1]), jnp.asarray(gt[1:]))
    rel = np.asarray(jse2.T_from_pose(
        jse2.pose_from_T(rel) + jnp.asarray(rng.normal(0, 0.01,
                                                       (n - 1, 3)))))
    if span_mode == "fixed":
        li = np.arange(0, n - G - 1, G)
        lj = li + G
    elif span_mode == "none":
        li = np.zeros((0,), np.int64)
        lj = li
    else:
        li = rng.integers(0, n - G, 25)
        lj = li + rng.integers(1, G + 1, 25)
    lm = np.asarray(jse2.get_relative_pose(jnp.asarray(gt[li]),
                                           jnp.asarray(gt[lj])))
    mask = rng.random(len(li)) > 0.3
    init = gt + rng.normal(0, 0.02, (n, 3))
    return init, dict(relative_poses=rel, loop_i=li, loop_j=lj,
                      loop_meas=lm, loop_mask=mask)


@pytest.mark.parametrize("n,G,span_mode", [
    (97, 10, "fixed"), (100, 10, "mixed"), (64, 7, "mixed"),
    (205, 10, "fixed"), (8, 10, "none")])
def test_banded_matches_direct_and_jax(n, G, span_mode):
    """tests/test_pose_graph.py:184-197 on the port: banded and direct
    reach the same optimum (the same LM iteration count, poses within
    1e-5, cost within rtol 1e-6), and the direct solve equals JAX's
    within 1e-9."""
    init, kw = _interval_graph(np.random.default_rng(n * 7 + G), n, G,
                               span_mode)
    tg = tpg.make_graph(torch.from_numpy(kw["relative_poses"]), TPGC(),
                        **{k: torch.from_numpy(v) for k, v in kw.items()
                           if k != "relative_poses"})
    x0 = torch.from_numpy(init)
    rd = tpg.optimize(x0, tg, max_iters=30, solver="direct")
    rb = tpg.optimize(x0, tg, max_iters=30, solver="banded", band=G)
    assert rd.iterations == rb.iterations
    np.testing.assert_allclose(rb.poses.numpy(), rd.poses.numpy(), rtol=0,
                               atol=1e-5)
    # (8, 10, "none") has no loop: both reach a cost of ~1e-28
    np.testing.assert_allclose(float(rb.cost), float(rd.cost), rtol=1e-6,
                               atol=1e-20)
    jg = jpg.make_graph(jnp.asarray(kw["relative_poses"]), JPGC(),
                        **{k: jnp.asarray(v) for k, v in kw.items()
                           if k != "relative_poses"})
    jd = jpg.optimize(jnp.asarray(init), jg, max_iters=30, solver="direct")
    assert rd.iterations == int(jd.iterations)
    np.testing.assert_allclose(rd.poses.numpy(), np.asarray(jd.poses),
                               rtol=0, atol=1e-9)


def test_banded_falls_back_to_direct_like_jax():
    """tests/test_pose_graph.py:199-240: a live loop wider than the band,
    and a reversed one, make optimize(solver="banded") run the direct
    solver (bit-equal to it, and to JAX's within 1e-9); masked wide loops
    keep the banded solve (within 1e-6 of direct)."""
    from lidar_slam_tpu.utils import se2 as jse2

    rng = np.random.default_rng(23)
    n = 60
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    rel = np.asarray(jse2.get_relative_pose(jnp.asarray(gt[:-1]),
                                            jnp.asarray(gt[1:])))
    li, lj = np.array([3, 10]), np.array([48, 20])
    lm = np.asarray(jse2.get_relative_pose(jnp.asarray(gt[li]),
                                           jnp.asarray(gt[lj])))
    init = gt + rng.normal(0, 0.05, (n, 3))
    cases = {"wide": (li, lj, lm, np.ones(2, bool)),
             "masked": (li, lj, lm, np.zeros(2, bool)),
             "reversed": (lj, li, np.linalg.inv(lm), np.ones(2, bool))}
    for name, (a, b, m, mask) in cases.items():
        kw = dict(loop_i=a, loop_j=b, loop_meas=m, loop_mask=mask)
        tg = tpg.make_graph(torch.from_numpy(rel), TPGC(),
                            **interop.from_numpy(kw))
        rb = tpg.optimize(torch.from_numpy(init), tg, max_iters=30,
                          solver="banded", band=10)
        rd = tpg.optimize(torch.from_numpy(init), tg, max_iters=30,
                          solver="direct")
        assert tpg.banded_exact(tg, 10) == (name == "masked")
        if name == "masked":
            np.testing.assert_allclose(rb.poses.numpy(), rd.poses.numpy(),
                                       rtol=0, atol=1e-6)
        else:
            assert torch.equal(rb.poses, rd.poses), name
        jg = jpg.make_graph(jnp.asarray(rel), JPGC(),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        jb = jpg.optimize(jnp.asarray(init), jg, max_iters=30,
                          solver="banded", band=10)
        np.testing.assert_allclose(rb.poses.numpy(), np.asarray(jb.poses),
                                   rtol=0, atol=1e-9, err_msg=name)


@pytest.fixture(scope="module")
def outlier_world():
    """tests/test_pose_graph_robust.py's world in float32: an arc with
    drifting odometry, anchors 0 -> j for j in 10..70 and one conflicting
    outlier anchor 0 -> 40 displaced by 2.5 m."""
    from lidar_slam_tpu.utils import se2 as jse2

    with jax.enable_x64(False):
        rng = np.random.default_rng(0)
        N = 80
        th = np.cumsum(np.full(N, 0.05))
        th[0] = 0
        gt = jnp.asarray(np.stack([np.cumsum(0.3 * np.cos(th)),
                                   np.cumsum(0.3 * np.sin(th)), th],
                                  -1).astype(np.float32))
        rel = jse2.get_relative_pose(gt[:-1], gt[1:])
        noise = rng.normal(0, 0.02, (N - 1, 3)).astype(np.float32)
        rel_noisy = jse2.T_from_pose(jse2.pose_from_T(rel)
                                     + jnp.asarray(noise))
        poses0 = jse2.pose_from_T(jse2.compose_chain(
            rel_noisy, jse2.T_from_pose(gt[0])))
        li = np.array([0] * 8, np.int32)
        lj = np.array([10, 20, 30, 40, 50, 60, 70, 40], np.int32)
        lmeas = np.asarray(jse2.get_relative_pose(gt[li[:7]], gt[lj[:7]]))
        bad = jse2.T_from_pose(
            jse2.pose_from_T(jse2.get_relative_pose(gt[0], gt[40])[None])[0]
            + jnp.asarray([2.5, -1.5, 0.6], jnp.float32))
        lmeas = np.concatenate([lmeas, np.asarray(bad)[None]], 0)
        return dict(gt=np.asarray(gt), poses0=np.asarray(poses0),
                    rel=np.asarray(rel_noisy), li=li, lj=lj,
                    lmeas=lmeas.astype(np.float32))


@pytest.mark.parametrize("robust,solver", [
    ("huber", "direct"), ("cauchy", "direct"), ("cauchy", "cg"),
    ("none", "direct")])
def test_robust_lm_matches_jax(outlier_world, robust, solver):
    """The IRLS robust kernels on the outlier world, float32, against JAX:
    the same LM iteration count, poses within 2e-5 (CG 1e-4), cost within
    rtol 1e-5; the robust solves side with the correct anchors (pose 40
    within 0.3 m, as tests/test_pose_graph_robust.py asks), the plain one
    splits the difference."""
    w = outlier_world
    kw = dict(loop_i=w["li"], loop_j=w["lj"], loop_meas=w["lmeas"],
              loop_mask=np.ones(8, bool))
    cfg = dict(solver=solver, robust_loss=robust, robust_delta=1.0,
               max_lm_iters=30)
    with jax.enable_x64(False):
        jg = jpg.make_graph(jnp.asarray(w["rel"]), JPGC(),
                            prior_pose=jnp.asarray(w["gt"][0]),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        jr = jpg.optimize_with_config(jnp.asarray(w["poses0"]), jg,
                                      JPGC(**cfg))
        j_poses, j_cost, j_it = (np.asarray(jr.poses), float(jr.cost),
                                 int(jr.iterations))
    tg = tpg.make_graph(torch.from_numpy(w["rel"]), TPGC(),
                        prior_pose=torch.from_numpy(w["gt"][0]),
                        **interop.from_numpy(kw))
    tr = tpg.optimize_with_config(torch.from_numpy(w["poses0"]), tg,
                                  TPGC(**cfg))
    assert tr.poses.dtype == torch.float32
    assert tr.iterations == j_it
    np.testing.assert_allclose(tr.poses.numpy(), j_poses, rtol=0,
                               atol=1e-4 if solver == "cg" else 2e-5)
    assert abs(float(tr.cost) - j_cost) <= 1e-5 * abs(j_cost)
    err40 = float(np.linalg.norm(tr.poses.numpy()[40, :2] - w["gt"][40, :2]))
    assert (err40 < 0.3) == (robust != "none"), err40


def test_robust_weight_and_cost_match_jax():
    """_robust_w_rho against JAX's on residuals inside and beyond delta,
    and on a masked factor (e2 = 0: weight 1, cost 0)."""
    e2 = np.array([0.0, 0.25, 1.0, 4.0, 100.0, 1e6], np.float64)
    for kind in ("huber", "cauchy"):
        for delta in (1.0, 0.5):
            jw, jrho = jpg._robust_w_rho(jnp.asarray(e2), kind, delta)
            tw, trho = tpg._robust_w_rho(torch.from_numpy(e2), kind, delta)
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-15)
            np.testing.assert_allclose(trho.numpy(), np.asarray(jrho),
                                       rtol=1e-15)
            assert float(tw[0]) == 1.0 and float(trho[0]) == 0.0


def test_cg_solve_matches_jax_cg():
    """cg_solve against jax.scipy.sparse.linalg.cg on an SPD system with a
    Jacobi preconditioner and a warm start, at a tolerance it reaches and
    at a cap of 5 iterations."""
    rng = np.random.default_rng(4)
    m = rng.normal(size=(40, 40))
    A = m @ m.T + 40 * np.eye(40)
    b = rng.normal(size=40)
    x0 = rng.normal(size=40) * 0.1
    dinv = 1.0 / np.diag(A)
    for tol, maxiter in ((1e-10, 250), (1e-12, 5)):
        want = jax.scipy.sparse.linalg.cg(
            lambda v: jnp.asarray(A) @ v, jnp.asarray(b), x0=jnp.asarray(x0),
            M=lambda v: jnp.asarray(dinv) * v, tol=tol, maxiter=maxiter)[0]
        At, dt = torch.from_numpy(A), torch.from_numpy(dinv)
        got = tpg.cg_solve(lambda v: At @ v, torch.from_numpy(b),
                           torch.from_numpy(x0), lambda v: dt * v, tol,
                           maxiter)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
