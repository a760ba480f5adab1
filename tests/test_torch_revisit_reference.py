"""The port's revisit deployment (run_slam gtsam with the descriptor
proposer and Huber loop factors) held to the benchmark's plain float64
revisit reference (slambench/reference/revisit.py), the benchmark's
two-lap log generator (slambench/synth_revisit.py) to the port's, and the
revisit stage's and direct solve's counters (utils/tracing), on the CPU.

One run of the port in float64 on a seeded two-lap log of 720 steps x 271
rays (every step of the second lap revisits the first's, 360 steps
earlier) serves every comparison; at 541 rays the CPU's scan matching
alone takes several times the file's budget."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "slambench"
if str(BENCH) not in sys.path:
    # appended, so that the benchmark's trace.py does not shadow the
    # standard library's
    sys.path.append(str(BENCH))

import synth_revisit  # noqa: E402
from reference import geometry as geo  # noqa: E402
from reference import posegraph as rpg  # noqa: E402
from reference import revisit as rrev  # noqa: E402

import lidar_slam_tpu_torch.config as tc  # noqa: E402
from lidar_slam_tpu_torch.models import slam  # noqa: E402
from lidar_slam_tpu_torch.utils import io, tracing  # noqa: E402

N_STEPS, N_RAYS, SEED, FI = 720, 271, 11, 10
# the configuration's revisit settings (slambench/configs/
# ece276a_ds20_revisit.json), the port's defaults
PG = dict(loop_proposer="descriptor", robust_loss="huber", robust_delta=1.0,
          descriptor_bins=64, descriptor_rel_thresh=4.0,
          descriptor_max_dist=5.0, proximity_min_gap=100,
          proximity_max_candidates=256, proximity_suppress=20,
          proximity_max_err=1e-4)
LOOPS = dict(epsilon=0.01, max_iters=2000, stopping_thresh=1e-4)
# Both sides verify a pair by one float64 ICP from the identity (its
# normalized error is under epsilon at once) on the same points; the fits'
# sums run in other orders, a few ULPs of metres apart.
MEAS_TOL = 1e-9
# The port's LM here stops only once a step gains under 1e-12 of the cost
# (cost_rtol); the reference's Huber LM runs to 1e-14.
PG_EXCESS_TOL = 1e-9


@pytest.fixture(scope="module")
def run():
    """The port's run in float64 with tracing on, its verified proposals,
    fixed loops and kept revisits recorded, and the log."""
    d = synth_revisit.synthetic_revisit_dataset(
        n_steps=N_STEPS, n_rays=N_RAYS, laps=2, seed=SEED)
    base = tc.SlamConfig()
    cfg = dataclasses.replace(
        base, lidar=dataclasses.replace(base.lidar, n_rays=N_RAYS),
        pose_graph=dataclasses.replace(base.pose_graph, cost_rtol=1e-12,
                                       max_lm_iters=100, **PG))
    rec = {}

    def recording(name, keep):
        orig = getattr(slam, name)

        def fn(*a, **k):
            out = orig(*a, **k)
            rec[name] = keep(a, out)
            return out
        return fn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(slam, "suppress_verified_pairs", recording(
            "suppress_verified_pairs", lambda a, keep: (*a[:4], keep)))
        mp.setattr(slam, "revisit_closures", recording(
            "revisit_closures", lambda a, rv: rv))
        mp.setattr(slam, "compute_loop_closures", recording(
            "compute_loop_closures", lambda a, out: out))
        tracing.reset()
        tracing.enable()
        try:
            res = slam.run_slam(
                d["encoder"]["counts"], d["imu"]["angular_velocity"],
                d["lidar"]["ranges"], 0.1, 30.0, mode="gtsam",
                fixed_interval=FI, cfg=cfg, build_map=False, device="cpu",
                dtype=torch.float64)
            counts = tracing.snapshot()["counts"]
        finally:
            tracing.disable()
            tracing.reset()
    ranges = torch.as_tensor(d["lidar"]["ranges"], dtype=torch.float64)
    pts, msk = geo.scan_points(ranges, 0.1, 30.0, np.radians(-135.0),
                               np.radians(135.0), cfg.lidar.p_rl[:2])
    return {"res": res, "rec": rec, "counts": counts, "ranges": ranges,
            "pts": pts, "msk": msk}


def _pairs(li, lj):
    return set(zip(np.asarray(li).tolist(), np.asarray(lj).tolist()))


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_generator_copy_equals_the_ports(seed):
    kw = dict(n_steps=240, n_rays=181, laps=2, seed=seed)
    want = io.synthetic_revisit_dataset(**kw)
    got = synth_revisit.synthetic_revisit_dataset(**kw)
    for key in ("encoder", "lidar", "imu", "rgbd"):
        assert want[key].keys() == got[key].keys()
        for k in want[key]:
            np.testing.assert_array_equal(got[key][k], want[key][k])
    np.testing.assert_array_equal(got["ground_truth"], want["ground_truth"])


def test_proposed_accepted_and_kept_sets_equal(run):
    li, lj, err, acc, keep = run["rec"]["suppress_verified_pairs"]
    ref = rrev.revisits(run["pts"], run["msk"], run["ranges"], run["msk"],
                        0.1, 30.0, LOOPS, PG)
    assert len(li) > 20 and keep.sum() > 5
    assert _pairs(li, lj) == _pairs(ref["proposed_i"], ref["proposed_j"])
    # the reference's verification of the port's proposals, pair by pair
    _, _, acc_ref = rrev.verify(run["pts"], run["msk"], li, lj, LOOPS, PG)
    np.testing.assert_array_equal(np.asarray(acc), acc_ref.numpy())
    res = run["res"]
    assert _pairs(res.revisit_pairs[:, 0], res.revisit_pairs[:, 1]) \
        == _pairs(ref["kept_i"], ref["kept_j"]) \
        == _pairs(np.asarray(li)[keep], np.asarray(lj)[keep])


def test_revisit_measurements_within_tolerance(run):
    rv = run["rec"]["revisit_closures"]
    T, _, _ = rrev.verify(run["pts"], run["msk"], rv.loop_i.numpy(),
                          rv.loop_j.numpy(), LOOPS, PG)
    gaps = geo.pose_gap(geo.pose_of(geo.inv(T)), geo.pose_of(rv.meas))
    assert float(gaps.max()) <= MEAS_TOL


def test_pose_graph_at_the_huber_optimum(run):
    res, rec = run["res"], run["rec"]
    loop_T, accept = rec["compute_loop_closures"][:2]
    rv = rec["revisit_closures"]
    li = torch.arange(0, N_STEPS - FI, FI)[accept]
    g = rrev.RobustGraph(rpg.Graph(
        torch.as_tensor(res.relative_poses_scan_matching),
        torch.cat([li, rv.loop_i]), torch.cat([li + FI, rv.loop_j]),
        torch.cat([loop_T[accept], rv.meas]), (0.1,) * 3, (0.3,) * 3,
        (0.3,) * 3), PG["robust_delta"])
    x_opt, c_opt = rrev.optimize(
        g, torch.as_tensor(res.poses_scan_matching, dtype=torch.float64))
    excess = (g.cost(torch.as_tensor(res.poses_optimized)) - c_opt) / max(
        c_opt, 1.0)
    assert excess <= PG_EXCESS_TOL
    # the revisit factors carry weight: some lie beyond the Huber width at
    # the scan-matched poses, and the optimum moves the trajectory
    rl = g.g.residuals(torch.as_tensor(res.poses_scan_matching))[1][N_STEPS
                                                                    - 1:]
    assert float((rl * rl).sum(-1).max()) > PG["robust_delta"] ** 2
    assert float(geo.pose_gap(x_opt, torch.as_tensor(
        res.poses_scan_matching)).max()) > 0.1


def test_tracing_counts_what_the_result_says(run):
    res, c = run["res"], run["counts"]
    kept = len(res.revisit_pairs)
    assert c["revisit.proposed"] == res.revisit_proposed > 0
    assert c["revisit.kept"] == kept > 0
    assert c["pose_graph.iterations"] == res.lm_iterations > 1
    assert c["pose_graph.woodbury_columns"] == res.lm_iterations * (
        1 + 3 * (len(res.loop_accept) + kept))
