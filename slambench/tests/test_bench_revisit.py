"""The revisit deployment's cell (ds20.offline_revisit) on the CPU: a small
run of it, unbroken, is correct, and with a fault planted in the program's
revisit stage or pose graph one limited number catches it; a traced run
reports the revisit stage's and direct solve's metrics and the offline
runner's; control.py reads the cell; and K6's work count
(work_tridiag.py) against a hand count.

The small cell is a two-lap log of 720 steps x 181 rays (360 steps a lap:
below about 200 steps a lap, proximity_min_gap = 100 proposes nothing
worth verifying) and no warm-up log. Two faults need it changed, as the
filtered cell's tests speed their corridor up, so that the fault changes
the program's result at all:
  huber_off         a Huber width of 0.05 in whitened units: at the
                    configuration's 1.0 no loop factor of a log this small
                    lies beyond the width at the optimum, where the Huber
                    and least-squares optima coincide;
  every_proposal_accepted  a log of 1,440 steps and a descriptor
                    threshold of 16 x the median consecutive-scan
                    distance: at 720 steps and 4 x it proposes 4 aliased
                    pairs among 60, and with the gates open 1 of them
                    outlasts the suppression; here 135 of 256 proposals
                    fail the gates, and with them open 30 pairs of the
                    kept set change."""

import copy

import numpy as np
import pytest
import torch

from bench_paths import cpu_run, harness, tiny_cell
import control  # noqa: E402
import work_tridiag  # noqa: E402

CELL = "ds20.offline_revisit"
NEW = ["revisit.stage_s", "revisit.verify_s", "revisit.kept_per_log",
       "revisit.woodbury_columns"]


def small(steps: int = 720, **pose_graph):
    """The small cell of `steps` steps, with the pose-graph settings
    `pose_graph`."""
    cell = tiny_cell(CELL, steps=steps, rays=181)
    cfg = copy.deepcopy(cell.config)
    cfg["pose_graph"].update(pose_graph)
    return harness.Cell(**{**cell.__dict__, "config": cfg,
                           "traffic": dict(cell.traffic, warmup_logs=0)})


def inversion_dropped(mp):
    """The kept revisits' measurements left as the ICP gives them,
    T_j^-1 T_i, as the fixed loops' are."""
    import lidar_slam_tpu_torch.models.slam as slam
    from lidar_slam_tpu_torch.utils import se2

    orig = slam.revisit_closures

    def uninverted(*a, **k):
        rv = orig(*a, **k)
        return rv._replace(meas=se2.inverse_T(rv.meas))
    mp.setattr(slam, "revisit_closures", uninverted)


def huber_off(mp):
    """The pose graph solved by least squares."""
    import lidar_slam_tpu_torch.models.pose_graph as pose_graph

    orig = pose_graph.optimize
    mp.setattr(pose_graph, "optimize",
               lambda *a, **k: orig(*a, **{**k, "robust": "none"}))


def every_proposal_accepted(mp):
    """The verification's gates (translation and ICP error) open."""
    import dataclasses

    import lidar_slam_tpu_torch.models.slam as slam

    orig = slam.revisit_closures

    def open_gates(pts3, masks, poses, pg, *a, **k):
        pg = dataclasses.replace(pg, proximity_max_err=float("inf"),
                                 descriptor_max_dist=float("inf"))
        return orig(pts3, masks, poses, pg, *a, **k)
    mp.setattr(slam, "revisit_closures", open_gates)


def descriptor_bins_off_by_one(mp):
    """The histograms binned over one bin more than configured, so every
    bin's edges shift."""
    import lidar_slam_tpu_torch.models.slam as slam

    orig = slam.scan_descriptors
    mp.setattr(slam, "scan_descriptors",
               lambda r, m, lo, hi, n_bins=64: orig(r, m, lo, hi,
                                                    n_bins=n_bins + 1))


def capacitance_in_float16(mp):
    """The direct solve's capacitance system rounded to float16 before it
    is solved (the CPU solves no float16 system itself)."""
    orig = torch.linalg.solve
    mp.setattr(torch.linalg, "solve", lambda A, B, **k: orig(
        A.half().to(A.dtype), B.half().to(B.dtype), **k))


NARROW_HUBER = {"robust_delta": 0.05}
WIDE_PROPOSER = {"steps": 1440, "descriptor_rel_thresh": 16.0}
# each fault, the limited number that catches it and the small cell's
# settings it is planted in
FAULTS = [(inversion_dropped, "revisit_gap_p99", {}),
          (huber_off, "pg_excess", NARROW_HUBER),
          (every_proposal_accepted, "kept_flips", WIDE_PROPOSER),
          (descriptor_bins_off_by_one, "proposal_flips", {}),
          (capacitance_in_float16, "pg_excess", {})]


@pytest.mark.parametrize("settings", [{}, NARROW_HUBER, WIDE_PROPOSER],
                         ids=["configured", "narrow_huber", "wide_proposer"])
def test_unbroken_small_cell_is_correct(settings):
    res = cpu_run(small(**settings), seconds=0.01)
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == set(harness.load_cell(CELL).spec[
        "limits"])


@pytest.mark.parametrize("fault,number,settings", FAULTS,
                         ids=[f.__name__ for f, _, _ in FAULTS])
def test_fault_is_caught_by_its_number(fault, number, settings,
                                       monkeypatch):
    fault(monkeypatch)
    res = cpu_run(small(**settings), seconds=0.01)
    assert not res["correct"], res["compared"]
    c = res["compared"][number]
    assert c["value"] > c["limit"], (number, c)


def test_traced_run_reports_the_revisit_and_offline_metrics():
    got = cpu_run(small(), seconds=0.01, trace=True)
    assert got["correct"], got["compared"]
    m = {k: v["value"] for k, v in got["metrics"].items()}
    for name in NEW + ["slam.scan_matching_s", "slam.loop_closures_s",
                       "slam.pose_graph_s", "slam.map_build_s",
                       "slam.pose_graph_solve_s", "slam.host_syncs_per_log",
                       "slam.lm_iterations_per_log"]:
        assert m[name] > 0, name
    assert m["slam.icp_sweeps_per_log"] >= 1
    # a direct solve's right-hand sides: 1 + 3 x (fixed candidates + kept)
    assert m["revisit.woodbury_columns"] == 1 + 3 * (
        len(range(0, 720 - 10, 10)) + m["revisit.kept_per_log"])
    assert 0 < m["device.idle_in_icp_share.offline"] <= 100
    # no device on the CPU: no K6 kernel in the trace
    assert "k6_roofline.revisit" not in m


def test_control_py_reads_the_cell():
    """control.py's program and control outputs for this cell, judged:
    every limited number, the control's revisit stage from its own
    pipeline."""
    cell = small()
    lim = cell.spec["limits"]
    rows = [control.readings(cell, [5], make, None, "cpu")[0]
            for make in (control.program_outputs, control.control_outputs)]
    for row in rows:
        assert set(lim) <= set(row)
        assert row["revisits_kept"] > 5
    assert rows[0]["lm_iterations"] > 1 and "lm_iterations" not in rows[1]


@pytest.mark.parametrize("shape,nbytes,ops", [
    # one segment of 3 scalar blocks (n <= 2q), m = 1: qi = 2 interior
    # blocks, panel M = 3 columns, a 1 x 1 product or inversion 2 ops:
    #   2 x (2 + 6 x 3)      inversions, panels, back-substitutions   40
    #   1 x 2 x 2            L = O G and A - L O^T                      4
    #   2 + 6 x 1            the interface block                        8
    #   6 x 2 + 4 x 1        the interface terms                       16
    #   4 x 1 + 2 x 4 x 1    the interiors                             12
    # bytes: A 3, O 2, R 3 read and X 3 written, 4 bytes each (float32
    # panels) or 8 (float64)
    ((3, 1, 1, 64, 4), 4 * (3 + 2 + 3 + 3), 40 + 4 + 8 + 16 + 12),
    ((3, 1, 1, 64, 8), 8 * (3 + 2 + 3 + 3), 40 + 4 + 8 + 16 + 12),
    # SPIKE, n = 10 blocks of 2 x 2 in B = 3 segments of q = 4 (the last
    # padded), m = 1: qi = 3, M = 5, a 2 x 2 product or inversion 16 ops:
    #   3 x 3 x (16 + 24 x 5)   = 1,224
    #   3 x 2 x 32              =   192
    #   3 x (16 + 24) + 2 x 32  =   184
    #   3 x (96 + 16)           =   336
    #   3 x (16 + 3 x 16)       =   192
    # bytes: A 40, O 36, R 20 read and X 20 written, 8 bytes each
    ((10, 2, 1, 4, 8), 8 * (40 + 36 + 20 + 20), 1224 + 192 + 184 + 336 + 192),
])
def test_k6_work_against_a_hand_count(shape, nbytes, ops):
    assert work_tridiag.k6_work(*shape) == (nbytes, ops)


def test_k6_roofline_share():
    """The least time is the larger bound: bytes at the direct shape, on
    the float64 panels the direct solve hands K6 on the card."""
    nbytes, ops = work_tridiag.k6_work(4956, 3, 1732, 64, 8)
    least = nbytes / work_tridiag.PEAKS["hbm_bytes_per_s"]
    assert least > ops / work_tridiag.FP64_FLOPS
    share = work_tridiag.roofline_share(ops, nbytes, 2 * least)
    assert share == pytest.approx(50.0)
    assert work_tridiag.roofline_share(ops, nbytes, 0.0) is None
    assert np.isfinite(share)


def test_k6_roofline_reads_the_recorded_calls():
    """k6_roofline.revisit counts each K6 call the runner recorded at the
    shape and element size it was handed, over the K6 kernels' seconds:
    float64 panels read twice the bytes of float32 ones, and no call or no
    K6 kernel in the trace reads nothing."""
    metric = harness.load_module("metrics", "k6_roofline.revisit")
    secs = 0.0205
    kernels = {name: [secs / 3, 10] for name in work_tridiag.KERNELS}
    kernels["nn_argmin_kernel<4>"] = [1.0, 5]

    def share(calls, trace=True):
        run = harness.Run(work={"k6": calls})
        run.trace = {"kernels": kernels} if trace else None
        return metric.read(run)

    f64 = [(4956, 3, 1720, 64, 8)] * 10
    nbytes, ops = work_tridiag.k6_work(4956, 3, 1720, 64, 8)
    assert share(f64) == pytest.approx(work_tridiag.roofline_share(
        10 * ops, 10 * nbytes, secs))
    f32 = [c[:4] + (4,) for c in f64]
    assert share(f64) == pytest.approx(2 * share(f32))
    assert share([]) is None and share(f64, trace=False) is None
    kernels = {}
    assert share(f64) is None


def test_set_up_refuses_a_float32_direct_step_on_the_card():
    """The runner's set-up refuses a program that handed K6 float32
    Woodbury panels (m > 1) on the card, and holds neither the banded
    solve (m = 1), float64 panels, nor a CPU run to it."""
    gate = harness.load_module("runners", CELL.split(".")[1]
                               ).require_float64_direct_step
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f32 = [(4956, 3, 1, 64, 4), (4956, 3, 1720, 64, 4)]
    with pytest.raises(SystemExit, match=r"panels of \[4\] bytes"):
        gate(cuda, f32)
    gate(cuda, [(4956, 3, 1, 64, 4), (4956, 3, 1720, 64, 8)])
    gate(cuda, [])
    gate(cpu, f32)
