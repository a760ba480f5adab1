"""The filtered deployment's cell (ds20.offline_filtered) on the CPU: a
small run of it, unbroken, is correct, and with a fault planted in the
program's filter or answer it is not; a traced run reports the filter's
metrics and the offline runner's; control.py reads the cell. (On a card,
test_bench_control.py holds its control to the limits.)

The small cell keeps the deployment's 1,081 rays (DBSCAN at eps 0.1 m
needs them) and 0.05 m cells on a 48-step log driven ten times as fast, so
that its scans see as many places along the corridors as 480 steps do
(the flips of a filter fault lie where a scan's points are sparse, at
corridor ends and corners) and a 0.01 shift of the poses moves more map
cells than the cell's limit allows (it reads 1,026 there, 425 on half
the log); no warm-up log."""

import copy

import pytest
import torch

from bench_paths import cpu_run, harness, tiny_cell
import control  # noqa: E402

CELL = "ds20.offline_filtered"


def _small():
    cell = tiny_cell(CELL, steps=48, rays=1081, res=0.05)
    cfg = copy.deepcopy(cell.config)
    cfg["log"].update(speed=10 * cfg["log"]["speed"],
                      speed_amp=10 * cfg["log"]["speed_amp"])
    return harness.Cell(**{**cell.__dict__, "config": cfg,
                           "traffic": dict(cell.traffic, warmup_logs=0)})


def _run():
    return cpu_run(_small(), seconds=0.01)


def _filter_skipped(mp):
    import lidar_slam_tpu_torch.models.slam as slam

    orig = slam.run_slam
    mp.setattr(slam, "run_slam",
               lambda *a, **k: orig(*a, **{**k, "filter_lidar": False}))


def _dbscan_min_samples_9(mp):
    import lidar_slam_tpu_torch.ops.filters as filters

    orig = filters.dbscan_filter_scans
    mp.setattr(filters, "dbscan_filter_scans",
               lambda p, m, eps=0.1, min_samples=10, **k: orig(
                   p, m, eps=eps, min_samples=9, **k))


def _d2_in_bfloat16(mp):
    import lidar_slam_tpu_torch.ops.filters as filters

    orig = filters._pair_d2
    mp.setattr(filters, "_pair_d2",
               lambda p: orig(p).to(torch.bfloat16).to(p.dtype))


def _statistical_dropped(mp):
    import lidar_slam_tpu_torch.ops.filters as filters

    mp.setattr(filters, "statistical_filter_scans",
               lambda points, masks, k_std=2.0: masks.bool())


def _poses_moved(mp):
    import lidar_slam_tpu_torch.models.slam as slam

    orig = slam.run_slam

    def moved(*a, **k):
        res = orig(*a, **k)
        res.poses_optimized = res.poses_optimized + 0.01
        return res
    mp.setattr(slam, "run_slam", moved)


FAULTS = [_filter_skipped, _dbscan_min_samples_9, _d2_in_bfloat16,
          _statistical_dropped, _poses_moved]


def test_unbroken_small_cell_is_correct():
    res = _run()
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1
    assert set(res["compared"]) == set(harness.load_cell(CELL).spec[
        "limits"])


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__.strip("_") for f in FAULTS])
def test_fault_makes_the_run_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["compared"]


def test_traced_run_reports_the_filter_and_offline_metrics():
    cell = _small()
    got = cpu_run(cell, seconds=0.01, trace=True)
    assert got["correct"], got["compared"]
    m = {k: v["value"] for k, v in got["metrics"].items()}
    n, rays = cell.config["log"]["n_steps"], cell.config["log"]["n_rays"]
    assert m["filtered.filter_pairs_per_log"] == n * rays * rays
    for name in ("filtered.filter_s", "filtered.dbscan_s",
                 "slam.scan_matching_s", "slam.loop_closures_s",
                 "slam.pose_graph_s", "slam.map_build_s",
                 "slam.pose_graph_solve_s", "slam.host_syncs_per_log"):
        assert m[name] > 0, name
    assert m["slam.icp_sweeps_per_log"] >= 1
    assert 0 < m["device.idle_in_icp_share.offline"] <= 100
    # no device on the CPU: no busy time inside the filter's spans
    assert "filter_roofline" not in m


def test_control_py_reads_the_cell():
    """control.py's program and control outputs for this cell, judged:
    every limited number, and the control's kept mask in filter_flips."""
    cell = _small()
    lim = cell.spec["limits"]
    for make in (control.program_outputs, control.control_outputs):
        row, = control.readings(cell, [5], make, None, "cpu")
        assert set(lim) <= set(row)
        assert row["kept_share"] > 0.5
