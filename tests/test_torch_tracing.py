"""The port's spans and counters (utils/tracing): off, a shared no-op;
on, nested spans with their roots, the counters exact on the program's
paths; and no read back from the device added, on or off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.kernels.nn import nn_argmin
from lidar_slam_tpu_torch.models import online
from lidar_slam_tpu_torch.models import particle_filter as pfm
from lidar_slam_tpu_torch.models import slam
from lidar_slam_tpu_torch.models.odometry import v_from_encoder
from lidar_slam_tpu_torch.ops import icp as icp_ops
from lidar_slam_tpu_torch.ops import scan as scan_ops
from lidar_slam_tpu_torch.utils import io, tracing

N_STEPS, N_RAYS, CHUNK = 60, 181, 16
STAGES = {
    ("odom", False, True): {"odometry", "map_build"},
    ("scan_matching", False, True): {"odometry", "scan_matching",
                                     "map_build"},
    ("gtsam", False, True): {"odometry", "scan_matching", "loop_closures",
                             "pose_graph", "map_build"},
    ("gtsam", True, True): {"odometry", "filter", "scan_matching",
                            "loop_closures", "pose_graph", "map_build"},
    ("gtsam", False, False): {"odometry", "scan_matching", "loop_closures",
                              "pose_graph"},
}


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _cfg():
    return tc.SlamConfig(
        lidar=tc.LidarConfig(n_rays=N_RAYS),
        map=tc.MapConfig(resolution=0.2, world_max_x=10, world_min_x=-10,
                         world_max_y=10, world_min_y=-10))


@pytest.fixture(scope="module")
def log():
    d = io.synthetic_dataset(n_steps=N_STEPS, n_rays=N_RAYS, seed=7)
    return (d["encoder"]["counts"].astype(np.float32),
            d["imu"]["angular_velocity"].astype(np.float32),
            d["lidar"]["ranges"].astype(np.float32))


def _run_slam(log, mode="gtsam", **kw):
    return slam.run_slam(*log, 0.1, 30.0, mode=mode, cfg=_cfg(),
                         chunk_size=CHUNK, device="cpu", **kw)


def _online(log, steps=12):
    counts, gyro, ranges = log
    cfg = _cfg()
    pts, m = scan_ops.scans_to_points(torch.from_numpy(ranges), 0.1, 30.0,
                                      cfg.lidar)
    st = online.init_state(pts[0], m[0], cfg, n_max=64, device="cpu")
    for t in range(1, steps + 1):
        st = online.online_step(st, torch.from_numpy(counts[t]),
                                torch.from_numpy(gyro[t]), pts[t], m[t], cfg)
    return st


@pytest.fixture(scope="module")
def im(log):
    """The PF's map: the log painted at its odometry, occupied cells 1."""
    res = _run_slam(log, mode="odom")
    return torch.from_numpy(res.logodds > 0).to(torch.float32)


def _pf(log, im, steps=8):
    counts, gyro, ranges = log
    cfg = _cfg()
    pts, m = scan_ops.scans_to_points(torch.from_numpy(ranges), 0.1, 30.0,
                                      cfg.lidar)
    pcfg = pfm.PFConfig(n_particles=32)
    st = pfm.init_pf_state(pcfg, seed=3, device="cpu")
    ests = []
    for t in range(1, steps + 1):
        st, (est, _, _) = pfm.pf_step(
            st, v_from_encoder(torch.from_numpy(counts[t])),
            torch.from_numpy(gyro[t])[-1], pts[t], m[t], im, cfg.map, pcfg)
        ests.append(est)
    return st, torch.stack(ests)


def test_off_span_is_one_shared_noop_and_records_nothing():
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b
    with a:
        with b:
            tracing.count("icp.sweeps", 5)
    assert tracing.snapshot()["spans"] == []
    assert "icp.sweeps" not in tracing.snapshot()["counts"]


def test_on_spans_nest_with_parents_and_roots_and_reset_clears():
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("d"):
            tracing.count("n", 2)
    with tracing.span("e"):
        tracing.count("n")
    snap = tracing.snapshot()
    by = {s.name: s for s in snap["spans"]}
    assert [s.name for s in snap["spans"]] == ["c", "b", "d", "a", "e"]
    assert by["a"].parent == 0 and by["a"].root == by["a"].id
    assert by["b"].parent == by["a"].id and by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    assert {by[k].root for k in "abcd"} == {by["a"].id}
    assert by["e"].parent == 0 and by["e"].root == by["e"].id != by["a"].id
    assert all(s.start_ns <= s.end_ns for s in snap["spans"])
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].end_ns \
        <= by["b"].end_ns <= by["d"].start_ns <= by["a"].end_ns
    assert snap["counts"]["n"] == 3
    tracing.reset()
    snap = tracing.snapshot()
    assert snap["spans"] == [] and "n" not in snap["counts"]


def test_stage_span_times_on_and_off():
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        seconds = {}
        with tracing.span("slam.odometry", seconds):
            pass
        assert set(seconds) == {"odometry"} and seconds["odometry"] >= 0
        assert len(tracing.snapshot()["spans"]) == int(on)


def test_snapshot_carries_the_wrappers_launches(monkeypatch):
    tracing.reset()
    monkeypatch.setattr(nn_argmin, "launches", nn_argmin.launches + 3)
    counts = tracing.snapshot()["counts"]
    assert counts["launches.nn_argmin"] == 3
    assert counts["launches.raywalk_build"] == 0
    assert counts["launches.raywalk_scan"] == 0


def test_spans_appear_in_a_cpu_profiler_trace():
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("pf.step"):
            with tracing.span("pf.score"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "pf.step" in names and "pf.score" in names
    # without a profiler no range is opened, the span still recorded
    with tracing.span("pf.weigh_resample"):
        pass
    assert [s.name for s in tracing.snapshot()["spans"]] == [
        "pf.score", "pf.step", "pf.weigh_resample"]


def test_online_step_counts_sweeps_and_syncs(log, monkeypatch):
    iters = []
    orig = icp_ops.run_icp_batch

    def recording(*a, **k):
        res = orig(*a, **k)
        iters.append(int(res.iters[0]))
        return res

    monkeypatch.setattr(icp_ops, "run_icp_batch", recording)
    tracing.enable()
    _online(log, steps=12)
    snap = tracing.snapshot()
    c = snap["counts"]
    assert len(iters) == 12 and sum(iters) > 12
    assert c["icp.sweeps"] == sum(iters)
    assert c["host.syncs"] == c["icp.sweeps"]
    roots = {s.id for s in snap["spans"] if s.name == "online.step"}
    assert len(roots) == 12
    for name in ("icp.batch", "online.map_update"):
        spans = [s for s in snap["spans"] if s.name == name]
        assert len(spans) == 12
        assert {s.parent for s in spans} == roots
        assert {s.root for s in spans} == roots


def test_loss_gate_read_is_counted(log):
    cfg = _cfg()
    counts, gyro, ranges = log
    pts, m = scan_ops.scans_to_points(torch.from_numpy(ranges), 0.1, 30.0,
                                      cfg.lidar)
    st = online.init_state(pts[0], m[0], cfg, n_max=16, device="cpu")
    gated = tc.SlamConfig(lidar=cfg.lidar, map=cfg.map,
                          online=tc.OnlineConfig(loss_rms_thresh=10.0))
    tracing.enable()
    online.online_step(st, torch.from_numpy(counts[1]),
                       torch.from_numpy(gyro[1]), pts[1], m[1], gated)
    c = tracing.snapshot()["counts"]
    assert c["host.syncs"] == c["icp.sweeps"] + 1


def _chunk_maxima(iters, chunk):
    c = min(chunk, len(iters))
    return sum(int(iters[i:i + c].max()) for i in range(0, len(iters), c))


def test_run_slam_gtsam_sweeps_are_the_chunks_longest(log):
    tracing.enable()
    res = _run_slam(log)
    snap = tracing.snapshot()
    want = (_chunk_maxima(res.scan_matching_iters, CHUNK)
            + _chunk_maxima(res.loop_iters, CHUNK))
    assert snap["counts"]["icp.sweeps"] == want
    n_chunks = -(-(N_STEPS - 1) // CHUNK) + -(-len(res.loop_iters) // CHUNK)
    spans = snap["spans"]
    root = [s for s in spans if s.name == "slam.run"]
    assert len(root) == 1 and all(s.root == root[0].id for s in spans)
    assert sum(s.name == "icp.batch" for s in spans) == n_chunks
    assert sum(s.name == "pose_graph.solve" for s in spans) \
        == res.lm_iterations == snap["counts"]["pose_graph.iterations"]
    stages = {s.name.split(".", 1)[1]: (s.end_ns - s.start_ns) * 1e-9
              for s in spans if s.parent == root[0].id}
    assert stages == res.stage_seconds


def test_pf_step_reads_nothing_back(log, im):
    tracing.enable()
    _pf(log, im, steps=8)
    snap = tracing.snapshot()
    assert snap["counts"].get("host.syncs", 0) == 0
    roots = {s.id for s in snap["spans"] if s.name == "pf.step"}
    assert len(roots) == 8
    for name in ("pf.score", "pf.weigh_resample"):
        assert sorted(s.parent for s in snap["spans"]
                      if s.name == name) == sorted(roots)


READS = ("__bool__", "__int__", "__float__", "__index__", "item", "cpu",
         "tolist", "numpy")


def _reads_and_outputs(monkeypatch, fn):
    n = [0]
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            n[0] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    out = fn()
    monkeypatch.undo()
    return n[0], out


@pytest.mark.parametrize("path", ["run_slam", "online_step", "pf_step"])
def test_tracing_adds_no_read_and_changes_no_output(log, im, monkeypatch,
                                                    path):
    def work():
        if path == "run_slam":
            r = _run_slam(log)
            return [r.poses, r.poses_optimized, r.logodds,
                    r.scan_matching_iters, r.loop_accept]
        if path == "online_step":
            st = _online(log, steps=10)
            return [t.numpy() for t in (st.pose, st.logodds, st.poses_hist)]
        st, ests = _pf(log, im, steps=6)
        return [st.particles.numpy(), st.logw.numpy(), ests.numpy()]

    reads_off, out_off = _reads_and_outputs(monkeypatch, work)
    tracing.enable()
    reads_on, out_on = _reads_and_outputs(monkeypatch, work)
    syncs = tracing.snapshot()["counts"].get("host.syncs", 0)
    assert reads_on == reads_off
    for a, b in zip(out_off, out_on):
        np.testing.assert_array_equal(a, b)
    tracing.reset()
    _reads_and_outputs(monkeypatch, work)
    assert tracing.snapshot()["counts"].get("host.syncs", 0) == syncs
    assert (syncs > 0) == (path != "pf_step")


@pytest.mark.parametrize("mode,filter_lidar,build_map", sorted(STAGES))
def test_stage_seconds_keys_on_and_off(log, mode, filter_lidar, build_map):
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        res = _run_slam(log, mode=mode, filter_lidar=filter_lidar,
                        build_map=build_map)
        assert set(res.stage_seconds) == STAGES[mode, filter_lidar,
                                                build_map]
        assert all(v >= 0 for v in res.stage_seconds.values())


def test_resume_stage_seconds(log):
    poses = _run_slam(log, mode="odom", build_map=False).poses
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        res = slam.resume_from_poses(poses, log[2], 0.1, 30.0, cfg=_cfg(),
                                     device="cpu")
        assert set(res.stage_seconds) == {"map_build"}
        assert slam.resume_from_poses(poses, log[2], 0.1, 30.0, cfg=_cfg(),
                                      build_map=False,
                                      device="cpu").stage_seconds == {}
