"""The port's revisit loop closures against the JAX package's, on the CPU.

Mirrors tests/test_loop_detection.py at small shapes: the revisit worlds
(bit-equal), the proximity and descriptor proposers (candidate sets
equal), post-verification suppression (keep masks equal), identity- and
estimate-seeded verification (accept masks equal, transforms within 1e-9
and errors within rtol 1e-6 in float64), and run_slam and online.refine
with each proposer (the same kept pairs, poses within 1e-9 in float64).
The exports, the metrics and the CLI flags of this slice are in
tests/test_torch_export.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import odometry as jodo
from lidar_slam_tpu.models import online as jon
from lidar_slam_tpu.models import scan_matching as jsm
from lidar_slam_tpu.models import slam as jslam
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.utils import io as jio

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import online as ton
from lidar_slam_tpu_torch.models import slam as tslam
from lidar_slam_tpu_torch.ops import icp as ticp
from lidar_slam_tpu_torch.utils import interop
from lidar_slam_tpu_torch.utils import io as tio

torch.set_num_threads(1)

# a two-lap circle (every lap-2 pose revisits lap 1) and a reversed lap
# (lap 2 retraces lap 1 at a 180-degree heading difference)
REVISIT = dict(n_steps=240, n_rays=181, laps=2)
REVERSE = dict(n_lap=150, n_rays=241, radius=2.0)
# refine's in-window descriptor bins the points' norms; on REVISIT's window
# its 479 proposals pass the cap of 256, and the light suppression then
# follows near-equal distances that the port's and XLA's float32 matmuls
# round apart (test_descriptor_distances_of_point_norms), so refine runs
# on a 271-ray window whose capped lists agree
REFINE_WORLD = dict(n_steps=360, n_rays=271, laps=2)


def _cfg(C, n_rays, **pg):
    cfg = C.SlamConfig(lidar=C.LidarConfig(n_rays=n_rays),
                       icp=C.IcpConfig(epsilon=0.001))
    return dataclasses.replace(cfg, pose_graph=dataclasses.replace(
        cfg.pose_graph, max_lm_iters=30, **pg))


PG = {
    "descriptor": (REVISIT, dict(loop_proposer="descriptor",
                                 robust_loss="cauchy")),
    "proximity": (REVISIT, dict(loop_proposer="proximity",
                                robust_loss="huber", proximity_radius=3.0)),
    "seeded": (REVERSE, dict(loop_proposer="proximity",
                             proximity_seed="estimate", proximity_trim=0.55,
                             proximity_radius=2.0, robust_loss="huber")),
}


def _world(kw):
    return (jio.synthetic_revisit_dataset(**kw) if "laps" in kw
            else jio.synthetic_reverse_lap_dataset(**kw))


@pytest.fixture(scope="module")
def scenes():
    """Per world: the log, JAX's float64 points, masks and scan-matching
    estimate (chunk 16)."""
    out = {}
    for name, kw in (("revisit", REVISIT), ("reverse", REVERSE),
                     ("refine", REFINE_WORLD)):
        d = _world(kw)
        cfg = _cfg(jc, kw["n_rays"])
        pts, masks = jscan.scans_to_points(jnp.asarray(d["lidar"]["ranges"]),
                                           0.1, 30.0, cfg.lidar)
        odo = jodo.poses_from_odometry(
            jnp.asarray(d["encoder"]["counts"]),
            jnp.asarray(d["imu"]["angular_velocity"]))
        sm = jsm.poses_from_scan_matching(odo, pts, masks, cfg.icp,
                                          chunk_size=16)
        out[name] = dict(d=d, pts=np.asarray(pts), masks=np.asarray(masks),
                         est=np.asarray(sm.poses),
                         rel=np.asarray(sm.relative_poses))
    return out


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("gen,kw", [
    ("synthetic_revisit_dataset", {}),
    ("synthetic_revisit_dataset", dict(n_steps=200, n_rays=181, laps=3,
                                       gyro_scale=0.99, seed=4)),
    ("synthetic_reverse_lap_dataset", {}),
    ("synthetic_reverse_lap_dataset", dict(n_lap=90, turn_steps=12,
                                           n_rays=121)),
    ("synthetic_outback_dataset", {}),
    ("synthetic_outback_dataset", dict(n_steps=150, speed=0.5, seed=9)),
])
def test_revisit_worlds_equal_jax(gen, kw):
    _assert_tree_equal(getattr(tio, gen)(**kw), getattr(jio, gen)(**kw))


@pytest.mark.parametrize("on", ["estimate", "truth"])
def test_proximity_candidates_match_jax(scenes, on):
    """Candidate pairs on the drifted estimate and on the ground truth,
    under the cap (256) and under cap pressure (8, light suppression):
    the same pairs in the same order."""
    s = scenes["revisit"]
    poses = s["est"] if on == "estimate" else s["d"]["ground_truth"]
    total = 0
    for radius, cap in ((0.5, 256), (3.0, 256), (3.0, 8)):
        kw = dict(min_gap=100, radius=radius, max_candidates=cap,
                  suppress_window=20)
        want = jslam.proximity_loop_candidates(poses, **kw)
        got = tslam.proximity_loop_candidates(torch.from_numpy(poses), **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        total += want[0].size
    assert total > 8


def test_descriptor_candidates_match_jax(scenes):
    """scan_descriptors bit-equal to JAX's (and invariant to the rays'
    order), and the descriptor proposer's candidate SETS equal, under the
    cap and under cap pressure: the all-pairs matmul rounds apart from
    XLA's by ULPs, which may swap two candidates at near-equal distance in
    the order (on this scene, positions 7 and 8 of 25)."""
    s = scenes["revisit"]
    ranges, masks = s["d"]["lidar"]["ranges"], s["masks"]
    with jax.enable_x64(False):
        want = np.asarray(jslam.scan_descriptors(
            jnp.asarray(ranges, jnp.float32), jnp.asarray(masks), 0.1, 30.0))
    got = tslam.scan_descriptors(torch.from_numpy(ranges),
                                 torch.from_numpy(masks), 0.1, 30.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    perm = np.random.default_rng(0).permutation(ranges.shape[1])
    np.testing.assert_array_equal(tslam.scan_descriptors(
        torch.from_numpy(ranges[:, perm]), torch.from_numpy(masks[:, perm]),
        0.1, 30.0).numpy(), want)
    for rel, cap in ((4.0, 256), (4.0, 5), (40.0, 256)):
        kw = dict(min_gap=100, rel_thresh=rel, max_candidates=cap,
                  suppress_window=20)
        w = jslam.descriptor_loop_candidates(ranges, masks, 0.1, 30.0, **kw)
        g = tslam.descriptor_loop_candidates(torch.from_numpy(ranges),
                                             torch.from_numpy(masks), 0.1,
                                             30.0, **kw)
        assert g[0].dtype == w[0].dtype == np.int32
        assert sorted(zip(g[0], g[1])) == sorted(zip(w[0], w[1]))
        assert w[0].size > 0


def test_descriptor_distances_of_point_norms(scenes):
    """On REVISIT's points' norms (refine's descriptor input), the port's
    all-pairs descriptor distances against JAX's: the same k nearest per
    scan, the same consecutive-scan scale, distances within 1e-7 (XLA's
    CPU matmul and torch's round apart: measured 6.0e-8), the same pairs
    under the threshold; the cap and its light suppression then rank
    these near-equal distances."""
    s = scenes["revisit"]
    ranges = np.linalg.norm(s["pts"], axis=-1)
    with jax.enable_x64(False):
        desc = jslam.scan_descriptors(jnp.asarray(ranges, jnp.float32),
                                      jnp.asarray(s["masks"]), 0.1, 30.0)
        ji, jd2, jcons = map(np.asarray, jslam._nearest_descriptor_revisits(
            desc, 100, 4))
    ti, td2, tcons = (a.numpy() for a in tslam._nearest_descriptor_revisits(
        torch.from_numpy(np.asarray(desc)), 100, 4))
    np.testing.assert_array_equal(ti, ji)
    assert float(tcons) == float(jcons)
    fin = np.isfinite(jd2)
    np.testing.assert_array_equal(np.isfinite(td2), fin)
    assert np.abs(td2[fin] - jd2[fin]).max() <= 1e-7
    thresh = 4.0 * float(jcons)
    assert (td2 <= thresh).sum() == (jd2 <= thresh).sum() > 256
    np.testing.assert_array_equal(td2 <= thresh, jd2 <= thresh)


def test_descriptor_median_is_the_midpoint():
    """The consecutive-scan scale is jnp.median's midpoint of the two
    middle values on an even count (torch.median would take the lower)."""
    v = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tslam._median(v)) == 2.5 == float(jnp.median(
        jnp.asarray(v.numpy())))
    assert float(tslam._median(v[:3])) == 3.0


def test_suppression_matches_jax():
    """suppress_verified_pairs keep masks and _suppress_greedy positions
    equal to JAX's on random pairs, errors with ties and accept masks."""
    rng = np.random.default_rng(5)
    for trial in range(20):
        m = int(rng.integers(0, 60))
        li = rng.integers(0, 300, m)
        lj = li + rng.integers(100, 200, m)
        err = np.round(rng.random(m), 1)  # ties: the stable order decides
        acc = rng.random(m) > 0.3
        window = int(rng.integers(1, 40))
        np.testing.assert_array_equal(
            tslam.suppress_verified_pairs(li, lj, err, acc, window),
            jslam.suppress_verified_pairs(li, lj, err, acc, window))
        np.testing.assert_array_equal(
            tslam._suppress_greedy(li, lj, window, 7),
            jslam._suppress_greedy(li, lj, window, 7))


def test_identity_verification_matches_jax(scenes):
    """Identity-seeded, untrimmed verification of the ground-truth revisit
    proposals (compute_loop_closures_pairs, gate_yaw=False), float64:
    transforms within 1e-9, errors within rtol 1e-6, and the translation
    gate and the proximity_max_err gate accept the same pairs; some pass,
    some do not."""
    s = scenes["revisit"]
    li, lj = jslam.proximity_loop_candidates(s["d"]["ground_truth"],
                                             radius=0.5)
    pts3 = jicp.lift_to_3d(jnp.asarray(s["pts"]))
    jT, jacc, jerr, jit = jslam.compute_loop_closures_pairs(
        pts3, jnp.asarray(s["masks"]), jnp.asarray(li), jnp.asarray(lj),
        5.0, 0.0, chunk_size=16, gate_yaw=False)
    tT, tacc, terr, tit = tslam.compute_loop_closures_pairs(
        ticp.lift_to_3d(torch.from_numpy(s["pts"])),
        torch.from_numpy(s["masks"]), torch.from_numpy(li).long(),
        torch.from_numpy(lj).long(), 5.0, 0.0, chunk_size=16,
        gate_yaw=False)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-6)
    gate = np.asarray(jacc) & (np.asarray(jerr) < 1e-4)
    np.testing.assert_array_equal(tacc.numpy() & (terr.numpy() < 1e-4),
                                  gate)
    assert 0 < gate.sum() < gate.size


def test_seeded_verification_matches_jax(scenes):
    """verify_revisit_pairs_seeded (estimate seeds, TrICP 0.55, epsilon
    1e-9, the 32 control pairs' median floor and the yaw-correction gate)
    on the reversed lap's proximity proposals, with the estimate's last 80
    poses turned 0.6 rad (so the yaw gate rejects their pairs), float64:
    the accept masks equal, transforms within 1e-9, errors within rtol
    1e-6."""
    s = scenes["reverse"]
    pg_kw = PG["seeded"][1]
    li, lj = jslam.proximity_loop_candidates(s["est"], radius=2.0)
    # an estimate whose last 80 poses turned 0.6 rad: their seeds need a
    # yaw correction past the 20-degree gate
    est = s["est"].copy()
    est[240:, 2] += 0.6
    pts3 = jicp.lift_to_3d(jnp.asarray(s["pts"]))
    jT, jacc, jerr = jslam.verify_revisit_pairs_seeded(
        pts3, jnp.asarray(s["masks"]), li, lj, jnp.asarray(est),
        dataclasses.replace(jc.PoseGraphConfig(), **pg_kw), chunk_size=16)
    tT, tacc, terr = tslam.verify_revisit_pairs_seeded(
        ticp.lift_to_3d(torch.from_numpy(s["pts"])),
        torch.from_numpy(s["masks"]), li, lj, torch.from_numpy(est),
        dataclasses.replace(tc.PoseGraphConfig(), **pg_kw), chunk_size=16)
    np.testing.assert_array_equal(tacc, jacc)
    assert 0 < jacc.sum() < jacc.size
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(terr, jerr, rtol=1e-6)


def _jax_kept_pairs(s, cfg):
    """JAX's run_slam revisit block (slam.py:516-577) on its own
    scan-matching estimate: the kept (i, j) pairs in the order appended."""
    pg = cfg.pose_graph
    pts3 = jicp.lift_to_3d(jnp.asarray(s["pts"]))
    masks = jnp.asarray(s["masks"])
    if pg.loop_proposer == "proximity":
        li, lj = jslam.proximity_loop_candidates(
            s["est"], min_gap=pg.proximity_min_gap,
            radius=pg.proximity_radius,
            max_candidates=pg.proximity_max_candidates,
            suppress_window=pg.proximity_suppress)
    else:
        li, lj = jslam.descriptor_loop_candidates(
            s["d"]["lidar"]["ranges"], masks, 0.1, 30.0,
            min_gap=pg.proximity_min_gap, n_bins=pg.descriptor_bins,
            rel_thresh=pg.descriptor_rel_thresh,
            max_candidates=pg.proximity_max_candidates,
            suppress_window=pg.proximity_suppress)
    if pg.proximity_seed == "estimate":
        _, acc, err = jslam.verify_revisit_pairs_seeded(
            pts3, masks, li, lj, jnp.asarray(s["est"]), pg, chunk_size=16)
    else:
        max_dist = (2.0 * pg.proximity_radius
                    if pg.loop_proposer == "proximity"
                    else pg.descriptor_max_dist)
        _, acc, err, _ = jslam.compute_loop_closures_pairs(
            pts3, masks, jnp.asarray(li), jnp.asarray(lj), float(max_dist),
            0.0, chunk_size=16, gate_yaw=False)
        err = np.asarray(err)
        acc = np.asarray(acc) & (err < pg.proximity_max_err)
    keep = jslam.suppress_verified_pairs(li, lj, np.asarray(err), acc,
                                         pg.proximity_suppress)
    sel = np.where(keep)[0]
    return np.stack([li[sel], lj[sel]], -1), li.size


@pytest.mark.parametrize("case", ["descriptor", "proximity", "seeded"])
def test_run_slam_revisit_matches_jax(scenes, case):
    """run_slam(mode="gtsam") with each proposer against JAX's, float64:
    the same proposals and kept revisit pairs, the same loop count,
    scan-matching and optimized poses within 1e-9; a "revisit" stage; the
    kept closures improve on the scan-matching estimate. (In float32 the
    181-ray scan matching of this world already parts from JAX's by
    4.3e-4 through nearest-neighbour near-ties, as at full width:
    tests/test_torch_ops.py.)"""
    world, pg = PG[case]
    s = scenes["revisit" if "laps" in world else "reverse"]
    d = s["d"]
    args = tuple(a.astype(np.float64) for a in (
        d["encoder"]["counts"], d["imu"]["angular_velocity"],
        d["lidar"]["ranges"]))
    jcfg, tcfg = _cfg(jc, world["n_rays"], **pg), _cfg(tc, world["n_rays"],
                                                       **pg)
    jr = jslam.run_slam(*args, 0.1, 30.0, mode="gtsam", cfg=jcfg,
                        build_map=False, chunk_size=16)
    tr = tslam.run_slam(*args, 0.1, 30.0, mode="gtsam", cfg=tcfg,
                        build_map=False, chunk_size=16, device="cpu",
                        dtype=torch.float64)
    tol = 1e-9
    np.testing.assert_allclose(tr.poses_scan_matching, jr.poses_scan_matching,
                               rtol=0, atol=tol)
    kept, proposed = _jax_kept_pairs(s, jcfg)
    assert tr.revisit_proposed == proposed > 0
    # the same kept pairs (the descriptor's order of near-equal candidates
    # may differ, so the pairs are compared as a set)
    assert sorted(map(tuple, tr.revisit_pairs.tolist())) == sorted(
        map(tuple, kept.tolist()))
    assert tr.n_loop_closures == jr.n_loop_closures
    assert "revisit" in tr.stage_seconds
    np.testing.assert_allclose(tr.poses_optimized, jr.poses_optimized,
                               rtol=0, atol=tol)
    gt = d["ground_truth"]
    ate = lambda p: np.linalg.norm(p[:, :2] - gt[:, :2], axis=1).mean()  # noqa: E731,E501
    if len(kept):
        assert ate(tr.poses_optimized) < ate(tr.poses_scan_matching)
    assert (len(kept) > 0) == (case != "proximity")


@pytest.mark.parametrize("proposer", ["descriptor", "proximity", "seeded"])
def test_refine_with_proposers_matches_jax(scenes, proposer):
    """online.refine with in-window revisit closures: a window state made
    of the scan-matching track (both packages), the window's scans, the
    reference's per-step gates; float64 poses within 1e-9, and the revisit
    closures move the window toward the truth."""
    world, pg = PG[proposer]
    if "laps" in world:
        world, s = REFINE_WORLD, scenes["refine"]
    else:
        s = scenes["reverse"]
    n = s["est"].shape[0]
    d = s["d"]
    jcfg, tcfg = _cfg(jc, world["n_rays"], **pg), _cfg(tc, world["n_rays"],
                                                       **pg)
    jst = jon.init_state(jnp.asarray(s["pts"][0]), jnp.asarray(s["masks"][0]),
                         jcfg, n_max=n + 8, K=64)
    rel = np.concatenate([np.eye(3)[None], s["rel"]])
    hist = dict(poses_hist=np.zeros((n + 8, 3)), rel_hist=np.tile(
        np.eye(3), (n + 8, 1, 1)))
    hist["poses_hist"][:n] = s["est"]
    hist["rel_hist"][:n] = rel
    jst = jst._replace(step=jnp.asarray(n - 1, jnp.int32),
                       **{k: jnp.asarray(v) for k, v in hist.items()})
    tst = ton.OnlineState(**interop.from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}))
    md, my = jodo.max_step_gates(jnp.asarray(d["encoder"]["counts"]),
                                 jnp.asarray(d["imu"]["angular_velocity"]))
    kw = dict(max_distance=float(md), max_yaw_deg=float(my),
              descriptor_range=(0.1, 30.0))
    want = jon.refine(jst, jcfg, scans=s["pts"], scan_masks=s["masks"], **kw)
    got = ton.refine(tst, tcfg, scans=s["pts"], scan_masks=s["masks"], **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    fixed = ton.refine(tst, _cfg(tc, world["n_rays"]), scans=s["pts"],
                       scan_masks=s["masks"], **kw)
    gt = d["ground_truth"]
    ate = lambda p: np.linalg.norm(p[:, :2] - gt[:, :2], axis=1).mean()  # noqa: E731,E501
    if proposer != "proximity":
        assert ate(got) < ate(fixed)
