"""The program's spans and counters in a traced run (spans.py): the
idle-in-spans reduction on hand-made events, each metric that reads the
passes on a hand-made run, the passes skipped for a program without
utils/tracing, and a traced run of each small cell reporting them."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench_paths import cpu_run, harness, tiny_cell
import spans  # noqa: E402
import trace  # noqa: E402

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
NEW = {
    "ds20.offline_gtsam": ["slam.icp_sweeps_per_log",
                           "slam.host_syncs_per_log",
                           "slam.pose_graph_solve_s",
                           "device.idle_in_icp_share.offline"],
    "ds20.online_slam": ["online.icp_ms", "online.map_update_ms",
                         "online.icp_sweeps_per_step",
                         "online.host_syncs_per_step",
                         "device.idle_in_icp_share.slam"],
    "ds21.online_localize": ["pf.score_ms", "pf.weigh_resample_ms"],
}
RUNNER = {"ds20.offline_gtsam": "offline", "ds20.online_slam": "stream_slam",
          "ds21.online_localize": "stream_pf"}


def ev(name, a, b, dev=CPU, thread=1, mark=None):
    return SimpleNamespace(
        name=name, device_type=dev, thread=thread,
        time_range=SimpleNamespace(start=a, end=b),
        is_user_annotation=(dev == CPU and "." in name) if mark is None
        else mark)


def events():
    """A 100 us window; device ops [10, 30] (two overlapping), [60, 70]
    and one from 95 past the window's end, so idle [0, 10], [30, 60],
    [70, 95]. The spans' marks on the device (flagged, or named as a host
    span) and another thread's span are not work or host time."""
    return [
        ev(trace.WINDOW, 0, 100),
        ev("aten::mul", 1, 2, mark=False),
        ev("k1", 10, 20, CUDA), ev("k2", 15, 30, CUDA),
        ev("k3", 60, 70, CUDA), ev("k4", 95, 130, CUDA),
        ev(trace.WINDOW, 0, 100, CUDA),
        ev("icp.batch", 0, 100, CUDA, mark=True),
        ev("pf.score", 0, 100, CUDA, mark=False),
        ev("icp.batch", 5, 40), ev("icp.batch", 8, 12),  # nested
        ev("pf.score", 50, 80),  # splits the gaps at 50 and 80
        ev("pf.score", 0, 100, thread=2),
    ]


def test_idle_intervals_merge_overlap_and_skip_marks():
    window, idle = spans.idle_intervals(events())
    assert window == (0, 100, 1)
    assert idle == [(0, 10), (30, 60), (70, 95)]


def test_idle_in_spans():
    idle_s, window_s, by = spans.idle_in_spans(
        events(), {"icp.batch", "pf.score", "nothing"})
    assert (idle_s, window_s) == pytest.approx((65e-6, 100e-6))
    assert by == pytest.approx({
        "icp.batch": (5 + 10) * 1e-6,  # [5, 10] and [30, 40]
        "pf.score": (10 + 10) * 1e-6,  # [50, 60] and [70, 80]
        "nothing": 0.0})


def test_overlap_and_merge():
    assert spans.merge([(5, 6), (0, 2), (1, 3), (4, 4)]) == [(0, 3), (5, 6)]
    assert spans.overlap([(0, 3), (5, 9)], [(2, 6), (8, 20)]) == 1 + 1 + 1


def _run(runner, out):
    return harness.Run(work={"runner": runner, spans.KEY: out}, trace={},
                       state=object())


OFFLINE = {"spans": [("slam.run", 1.0, "slam.run"),
                     ("icp.batch", 0.2, "slam.run"),
                     ("icp.batch", 0.3, "slam.run"),
                     ("pose_graph.solve", 0.01, "slam.run"),
                     ("pose_graph.solve", 0.02, "slam.run")],
           "counts": {"icp.sweeps": 600, "host.syncs": 640},
           "idle_s": 2.0, "idle_in": {"icp.batch": 1.5}}
ONLINE = {"spans": [("online.step", 0.010, "online.step"),
                    ("icp.batch", 0.006, "online.step"),
                    ("online.map_update", 0.001, "online.step"),
                    ("online.step", 0.008, "online.step"),
                    ("icp.batch", 0.004, "online.step"),
                    ("online.map_update", 0.0005, "online.step"),
                    ("icp.batch", 1.0, "other")],
          "counts": {"icp.sweeps": 9, "host.syncs": 9},
          "idle_s": 4.0, "idle_in": {"icp.batch": 3.0}}
PF = {"spans": [("pf.step", 0.003, "pf.step"),
                ("pf.score", 0.001, "pf.step"),
                ("pf.weigh_resample", 0.0015, "pf.step"),
                ("pf.step", 0.002, "pf.step"),
                ("pf.score", 0.0006, "pf.step"),
                ("pf.weigh_resample", 0.0011, "pf.step")],
      "counts": {}, "idle_s": 1.0, "idle_in": {}}


@pytest.mark.parametrize("metric,runner,out,want", [
    ("slam.icp_sweeps_per_log", "offline", OFFLINE, 600),
    ("slam.host_syncs_per_log", "offline", OFFLINE, 640),
    ("slam.pose_graph_solve_s", "offline", OFFLINE, 0.03),
    ("device.idle_in_icp_share.offline", "offline", OFFLINE, 75.0),
    ("online.icp_ms", "stream_slam", ONLINE, 5.0),
    ("online.map_update_ms", "stream_slam", ONLINE, 0.75),
    ("online.icp_sweeps_per_step", "stream_slam", ONLINE, 4.5),
    ("online.host_syncs_per_step", "stream_slam", ONLINE, 4.5),
    ("device.idle_in_icp_share.slam", "stream_slam", ONLINE, 75.0),
    ("pf.score_ms", "stream_pf", PF, 0.8),
    ("pf.weigh_resample_ms", "stream_pf", PF, 1.3),
])
def test_metric_reads_the_passes(metric, runner, out, want):
    read = harness.load_module("metrics", metric).read
    assert read(_run(runner, out)) == pytest.approx(want)
    other = {"offline": "stream_pf"}.get(runner, "offline")
    assert read(_run(other, out)) is None
    assert read(_run(runner, None)) is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_no_passes_without_the_programs_tracing(cell, monkeypatch):
    def no_work(run):
        raise AssertionError("a pass ran")

    monkeypatch.setattr(spans, "tracing_module", lambda: None)
    monkeypatch.setattr(spans, "_work", no_work)
    run = harness.Run(work={"runner": RUNNER[cell]}, trace={},
                      state=object())
    for name in NEW[cell]:
        assert harness.load_module("metrics", name).read(run) is None
    assert run.work[spans.KEY] is None


def test_tracing_module_is_none_where_the_program_has_none(monkeypatch):
    monkeypatch.setattr(spans, "TRACING", "lidar_slam_tpu_torch.utils.none")
    assert spans.tracing_module() is None
    monkeypatch.setattr(spans, "TRACING", "no_such_package.tracing")
    assert spans.tracing_module() is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reports_the_new_metrics(cell, monkeypatch, capsys):
    got = cpu_run(tiny_cell(cell), trace=True)
    assert got["correct"]
    assert set(NEW[cell]) <= set(got["metrics"])
    assert "program trace: " in capsys.readouterr().err
    m = {k: v["value"] for k, v in got["metrics"].items()}
    if cell == "ds20.online_slam":
        assert m["online.host_syncs_per_step"] == m[
            "online.icp_sweeps_per_step"] >= 1
    for k in m:
        if k.startswith("device.idle_in_icp_share"):
            assert 0 < m[k] <= 100
    # a program without utils/tracing: the old metrics, and no new one
    monkeypatch.setattr(spans, "TRACING", "lidar_slam_tpu_torch.utils.none")
    old = cpu_run(tiny_cell(cell), trace=True)
    assert old["correct"]
    assert set(old["metrics"]) == set(got["metrics"]) - set(NEW[cell])
