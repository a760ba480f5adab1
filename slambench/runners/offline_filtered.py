"""Offline runner of the filtered deployment (main.py --mode gtsam
--filter_lidar): the offline runner's work (runners/offline.py: whole
logs through the program's run_slam, back to back, closed loop, each call
from the host's numpy log to the results on the host) on corridor logs
(synth_corridor), with run_slam's filter_lidar on.

Its state runs offline.one, offline.pipeline and offline.judge: its
`slam` is run_slam with the filter bound, and its traffic's runner kind
is "offline", so that control.py, spans.py and every metric that reads an
offline run read this one as well.

The judge holds one completed run, drawn from the seed, to the plain
reference in float64, which filters the log itself (reference/filters.py)
and runs its ICP, loops and map on its own filter's masks:
  filter_flips  points whose keep flag (after both filters) differs from
                the reference filter's, per million valid points of the
                log, so that a short log and a whole one are held to one
                limit; beside it, with no limit, the points themselves
                (filter_flipped_points), the share of valid points the
                program kept (kept_share) and the fewest it kept in a scan
                (kept_min);
  sm_gap ... map_cells   offline.judge's numbers on the filtered masks.
                The cell limits the 99th percentiles and medians, and not
                the widest gaps (PERF.md section 2);
and reports, with no limit, what shows the corridor's effect on them:
  lm_iterations     the program's LM iterations (its cap: max_lm_iters);
  loops_short       accepted loops whose translation is under half the
                    ground truth's between the pair's scans;
  sm_worst_along, sm_worst_across   the worst scan-matching pair's gap in
                    metres along and across the first scan's heading
                    (the corridor's axis, as the robot follows it);
  sm_worst_err_ratio  the program's transform's ICP error over the
                    reference's on that pair, both in float64;
  sm_worst_prog_truth, sm_worst_ref_truth  each transform's gap from the
                    ground truth's motion.

A traced run makes one log four times: (a) untraced, for run_slam's stage
seconds; (b) under torch.profiler (run.trace, the judged outputs, and
the sweeps and ray visits of the K4 and K1 rooflines); (c) with the
program's tracing on, for the spans and counters, and (d) with tracing on
under the profiler, for the device's busy time inside the slam.filter
spans. The runner makes (c) and (d) itself and keeps them in
run.work[spans.KEY], where spans.passes finds them. Passes (b) and (d)
read the profiler's raw events (raw_events), since its own event list
costs minutes for the events of a corridor log's pose graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import types
from typing import NamedTuple

import numpy as np
import torch

import common
import harness
import spans
import synth_corridor
import trace
import work_filter
from reference import filters as rfilt
from reference import geometry as geo
from reference import icp as ricp
from reference import mapping as rmap

offline = harness.load_module("runners", "offline")
KIND = "offline"  # the runner kind that control.py and spans.py run
FILTER_SPAN = "slam.filter"
one = offline.one


def make_log(config: dict, seed: int) -> dict:
    """One corridor log at the configuration's shapes, as common.make_log
    makes the room's: float32 as a sensor log stores it, the ground truth
    float64."""
    p = dict(config["log"])
    gen = p.pop("generator")
    if gen != "corridor_dataset":
        raise ValueError(f"unknown log generator {gen!r}")
    d = synth_corridor.corridor_dataset(seed=seed, **p)
    return {"counts": d["encoder"]["counts"].astype(np.float32),
            "gyro": d["imu"]["angular_velocity"].astype(np.float32),
            "ranges": d["lidar"]["ranges"].astype(np.float32),
            "gt": d["ground_truth"],
            "range_min": float(p["range_min"]),
            "range_max": float(p["range_max"])}


def slam_config(config: dict):
    """common.slam_config with the configuration's scan filters."""
    from lidar_slam_tpu_torch.config import FilterConfig

    return dataclasses.replace(common.slam_config(config),
                               filter=FilterConfig(**config["filter"]))


def _recording(slam, name: str, pick):
    """slam.<name>, wrapped once a process so that `pick` of each call's
    value is appended to the list at the wrapper's `record_to`."""
    fn = getattr(slam, name)
    if not hasattr(fn, "record_to"):
        orig = fn

        def fn(*a, **k):
            out = orig(*a, **k)
            fn.record_to.append(pick(out))
            return out
        setattr(slam, name, fn)
    return fn


def setup(env: harness.Env):
    import lidar_slam_tpu_torch.models.slam as slam

    st = offline.State()
    st.env, st.cfg = env, env.cell.config
    st.tr = dict(env.cell.traffic, runner=KIND)
    st.dev = torch.device(env.device)
    st.scfg = slam_config(st.cfg)
    st.phases = {"start_to_logs": harness.process_seconds()}
    st.logs = [make_log(st.cfg, s)
               for s in common.log_seeds(env.seed, st.tr["logs"])]
    st.phases["logs"] = harness.process_seconds() - st.phases["start_to_logs"]
    # the loop transforms and the kept masks, for the judge
    st.loops, st.keeps = [], []
    _recording(slam, "compute_loop_closures",
               lambda out: out[0]).record_to = st.loops
    _recording(slam, "filter_scans", lambda keep: keep).record_to = st.keeps
    st.slam = types.SimpleNamespace(run_slam=functools.partial(
        slam.run_slam, filter_lidar=st.cfg["filter_lidar"]))
    common.reset_peak(st.dev)
    for w in range(st.tr["warmup_logs"]):
        one(st, len(st.logs) - 1 - w % len(st.logs))
    common.sync(st.dev)
    forget(st)
    common.settle()
    return st


def forget(st) -> None:
    st.loops.clear()
    st.keeps.clear()


def outputs(st, i: int, res, loop_T, keep=None) -> dict:
    """offline.outputs with the program's kept mask (by default that of
    the run just made; None where the program filtered nothing) and its
    LM iterations."""
    out = offline.outputs(st, i, res, loop_T)
    if keep is None and st.keeps:
        keep = st.keeps[-1]
    out["keep"] = None if keep is None else keep.cpu().numpy()
    out["lm_iterations"] = res.lm_iterations
    return out


def run(env: harness.Env) -> harness.Run:
    st = setup(env)
    run = harness.Run(state=st)
    run.setup_s = harness.process_seconds()
    run.work["setup_phases"] = dict(st.phases, rest=run.setup_s - sum(
        st.phases.values()))
    run.work["runner"] = KIND
    log0 = st.logs[0]
    n_scans = log0["ranges"].shape[0]
    if env.trace:
        stages = dict(one(st, 0).stage_seconds)
        forget(st)
        with common.NNProbe() as probe:
            res, events, host_s = profiled(lambda: one(st, 0), st.dev)
        run.trace = trace.reduce(events)
        run.trace["host_window_s"] = host_s
        del events
        run.attempted = 1
        run.outputs = outputs(st, 0, res, st.loops[-1])
        m = common.map_geometry(st.cfg)
        pts, valid = common.points(st, 0, torch.float64)
        visits = rmap.ray_visits(
            torch.as_tensor(res.poses_optimized, dtype=torch.float64,
                            device=st.dev), pts,
            st.keeps[-1] if st.keeps else valid, m,
            common.lidar_geometry(st.cfg)["p_rl"])
        forget(st)
        run.work |= {
            "stage_seconds": [stages], "nn_sweeps": probe.sweeps(),
            "k1": {"scans": n_scans, "rays": pts.shape[1],
                   "width": m["width"], "height": m["height"],
                   "visits": visits},
            "filter": {"pairs": work_filter.valid_pairs(
                log0["ranges"], log0["range_min"], log0["range_max"]),
                "points": int(log0["ranges"].size)}}
        program_passes(run)
    else:
        rng = np.random.default_rng(abs(env.seed))
        stages, pick = [], None
        t0 = time.perf_counter()
        while True:
            i = len(stages) % len(st.logs)
            res = one(st, i)
            stages.append(res.stage_seconds)
            if rng.integers(len(stages)) == 0:  # each log alike likely
                pick = (i, res, st.loops[-1],
                        st.keeps[-1] if st.keeps else None)
            forget(st)
            if time.perf_counter() - t0 >= env.seconds:
                break
        run.window_s = time.perf_counter() - t0
        run.attempted = len(stages)
        run.work |= {"scans": n_scans * len(stages),
                     "stage_seconds": stages}
        run.outputs = outputs(st, *pick)
    return run


class _Range(NamedTuple):
    start: float
    end: float


class _Event:
    """A profiler event as trace.reduce and spans' helpers read it."""

    __slots__ = ("name", "device_type", "thread", "time_range",
                 "is_user_annotation")


def profiled(fn, dev):
    """(fn()'s value, its profiler events, host seconds): fn run under
    torch.profiler inside a trace.WINDOW span, the device synchronized
    before the span ends, as trace.traced and spans._profiled run it. The
    events come from raw_events: the profiler's own event list costs about
    90 us an event to build, minutes for the events of a corridor log's
    pose graph."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    common.sync(dev)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            t0 = time.perf_counter()
            out = fn()
            common.sync(dev)
            host_s = time.perf_counter() - t0
    return out, raw_events(prof), host_s


def raw_events(prof) -> list:
    """A finished profile's events from its raw results, each as trace.reduce
    reads it, times in microseconds from the first. They are the events
    of prof.events() and, besides, the nested repeats of an op that calls
    itself, which prof.events() drops; a repeat lies inside its parent and
    has its name, so the device's busy and idle times and the spans'
    intervals read the same."""
    raw = [e for e in prof.profiler.kineto_results.events()
           if not e.is_hidden_event()]
    base = min((e.start_ns() for e in raw), default=0)
    events = []
    for e in raw:
        ev = _Event()
        ev.name, ev.device_type = e.name(), e.device_type()
        ev.thread, ev.is_user_annotation = (e.start_thread_id(),
                                            e.is_user_annotation())
        ev.time_range = _Range((e.start_ns() - base) * 1e-3,
                               (e.end_ns() - base) * 1e-3)
        events.append(ev)
    return events


def program_passes(run: harness.Run) -> None:
    """Passes (c) and (d) of one log, kept in run.work[spans.KEY] as
    spans.passes keeps them, with the slam.filter spans' seconds on the
    profiler's clock (filter_span_s) and the device's busy seconds inside
    them (filter_busy_s); None where the program has no utils/tracing."""
    st = run.state
    tr = spans.tracing_module()
    if tr is None:
        run.work[spans.KEY] = None
        return
    try:
        tr.reset()
        tr.enable()
        common.sync(st.dev)
        t0 = time.perf_counter()
        one(st, 0)
        common.sync(st.dev)
        host_s = time.perf_counter() - t0
        out = spans._reduce(tr.snapshot())
        tr.reset()
        _, events, _ = profiled(lambda: one(st, 0), st.dev)
    finally:
        tr.disable()
        tr.reset()
        forget(st)
    names = {n for n, _, _ in out["spans"]} | {FILTER_SPAN}
    idle_s, window_s, idle_in = spans.idle_in_spans(events, names)
    window, _ = spans.idle_intervals(events)
    ivs = spans.span_intervals(events, {FILTER_SPAN}, window)[FILTER_SPAN]
    del events
    span_s = sum(b - a for a, b in ivs) * 1e-6
    out |= {"host_s": host_s, "idle_s": idle_s, "window_s": window_s,
            "idle_in": idle_in, "filter_span_s": span_s,
            "filter_busy_s": span_s - idle_in[FILTER_SPAN]}
    run.work[spans.KEY] = out
    spans._report(run, out)


@contextlib.contextmanager
def filtered_points(st):
    """Within the block, common.points hands out the reference filter's
    masks in place of the validity masks (each log and dtype filtered
    once; inside geometry.tf32() the filter's coordinates are rounded
    too), so that offline.pipeline and offline.judge run on the filtered
    scans."""
    orig, cache = common.points, {}
    f = st.cfg["filter"]

    def points(st_, i, dtype):
        pts, valid = orig(st_, i, dtype)
        if (i, dtype) not in cache:
            cache[i, dtype] = rfilt.filter_keep(
                pts, valid, f["dbscan_eps"], f["dbscan_min_samples"],
                f["statistical_k_std"])
        return pts, cache[i, dtype]

    common.points = points
    try:
        yield
    finally:
        common.points = orig


def pipeline(st, i: int, dtype, full: bool = True) -> dict:
    """offline.pipeline on the reference filter's masks in `dtype`, with
    that filter's kept mask ("keep"): the control's outputs (control.py).
    control.control_outputs passes on only the offline runner's keys, so
    the mask is also kept as st.control_keep, which the judge reads for
    outputs without one."""
    with filtered_points(st):
        out = offline.pipeline(st, i, dtype, full)
        _, out["keep"] = common.points(st, i, dtype)
    st.control_keep = out["keep"].cpu().numpy()
    return out


def _relative(poses: torch.Tensor, i, j) -> torch.Tensor:
    """(..., 3, 3) motions from poses i to poses j."""
    T = geo.T_of(poses)
    return geo.mm(geo.inv(T[i]), T[j])


def _icp_error(src, tgt, src_mask, tgt_mask, T) -> float:
    """Point-to-point ICP's error of one pair at T: the sum over valid
    source points, moved by T, of the squared distance to the nearest
    valid target point."""
    moved = geo.mm(src, T[:2, :2].T) + T[:2, 2]
    d2 = ((moved[:, None] - tgt[None]) ** 2).sum(-1)
    d2 = torch.where(tgt_mask[None], d2, torch.full_like(d2, float("inf")))
    return float(d2.amin(-1)[src_mask].sum())


def corridor_readings(st, out: dict, worst: int) -> dict:
    """The numbers with no limit that show the corridor's effect on the
    judge's (the module's docstring), on the reference filter's masks."""
    f64, dev, cfg = torch.float64, st.dev, st.cfg
    log = st.logs[out["log"]]
    gt = torch.as_tensor(log["gt"], dtype=f64, device=dev)
    fi = cfg["loops"]["fixed_interval"]
    li = torch.arange(0, gt.shape[0] - fi, fi, device=dev)
    t_gt = torch.linalg.vector_norm(_relative(gt, li, li + fi)[:, :2, 2],
                                    dim=-1)
    loop_T = torch.as_tensor(np.asarray(out["loop_T"]), dtype=f64,
                             device=dev)
    t_loop = torch.linalg.vector_norm(loop_T[:, :2, 2], dim=-1)
    acc = torch.as_tensor(np.asarray(out["accept"]), device=dev).bool()
    vals = {"loops_short": int((acc & (t_loop < 0.5 * t_gt)).sum())}
    if "lm_iterations" in out:
        vals["lm_iterations"] = int(out["lm_iterations"])
    # the worst scan-matching pair: the reference's ICP of it again
    rob, ic = cfg["robot"], cfg["icp"]
    odo = torch.as_tensor(geo.odometry(log["counts"], log["gyro"],
                                       rob["dist_per_tick"],
                                       rob["encoder_freq"]),
                          dtype=f64, device=dev)
    k = [worst]
    pts, msk = common.points(st, out["log"], f64)
    T_ref, _, _ = ricp.icp(pts[worst + 1:worst + 2], pts[worst:worst + 1],
                           msk[worst + 1:worst + 2], msk[worst:worst + 1],
                           _relative(odo, k, [worst + 1]), ic["epsilon"],
                           ic["max_iters"], ic["stopping_thresh"],
                           ic["normalize_error"])
    T_ref = T_ref[0]
    T_prog = torch.as_tensor(np.asarray(out["sm_rel"])[worst], dtype=f64,
                             device=dev)
    T_gt = _relative(gt, k, [worst + 1])[0]
    dx, dy = (T_prog[:2, 2] - T_ref[:2, 2]).abs().tolist()
    err = [_icp_error(pts[worst + 1], pts[worst], msk[worst + 1],
                      msk[worst], T) for T in (T_prog, T_ref)]
    vals |= {"sm_worst_along": dx, "sm_worst_across": dy,
             "sm_worst_err_ratio": err[0] / max(err[1], 1e-300),
             "sm_worst_prog_truth": float(geo.pose_gap(
                 geo.pose_of(T_prog), geo.pose_of(T_gt))),
             "sm_worst_ref_truth": float(geo.pose_gap(
                 geo.pose_of(T_ref), geo.pose_of(T_gt)))}
    return vals


def judge(st, out: dict) -> dict:
    i = out["log"]
    _, valid = common.points(st, i, torch.float64)
    with filtered_points(st):
        vals = offline.judge(st, out)
        vals |= corridor_readings(st, out, vals["sm_worst_pair"])
        _, ref_keep = common.points(st, i, torch.float64)
    keep = out["keep"] if "keep" in out else st.control_keep
    keep = valid if keep is None else torch.as_tensor(keep, device=st.dev)
    n_valid = max(1, int(valid.sum()))
    flips = int((keep != ref_keep).sum())
    vals["filter_flips"] = 1e6 * flips / n_valid
    vals["filter_flipped_points"] = flips
    vals["kept_share"] = float(keep.sum()) / n_valid
    vals["kept_min"] = int(keep.sum(-1).min())
    return vals
