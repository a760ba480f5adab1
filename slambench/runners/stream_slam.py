"""Streaming-SLAM runner: one step at a time through the program's
online.init_state and online.online_step, as online_slam.py's loop runs
them, closed loop. A step starts from the host's (counts, gyro, ranges)
row and ends with its pose on the host; at a log's end a new session
starts on the next log (its init_state is inside the window but is not a
step).

The judge takes the session that was running when the window closed and
holds it to the plain reference in float64, step by step from the
program's own poses (the chain composes every step's error, so two sound
runs drift apart; each step is judged on its own):
  step_gap   the widest gap (metres + radians), over steps sampled from the
             seed (the first and the last always), between the program's
             pose at step t and its pose at t - 1 composed with the
             reference's ICP of scan t onto scan t - 1, seeded by the
             reference's own odometry;
  map_cells  cells of the program's causal map more than 1e-3 from the
             reference's map of the session's scans painted at the
             program's poses.
"""

from __future__ import annotations

import numpy as np
import torch

import common
import harness
import trace
from reference import geometry as geo
from reference import icp as ricp
from reference import mapping as rmap
from reference.geometry import gap_stats as _stats


class State:
    pass


def setup(env: harness.Env) -> State:
    from lidar_slam_tpu_torch.models import online
    from lidar_slam_tpu_torch.ops import scan as scan_ops

    st = State()
    st.env, st.cfg, st.tr = env, env.cell.config, env.cell.traffic
    st.dev = torch.device(env.device)
    st.online, st.scan_ops = online, scan_ops
    st.scfg = common.slam_config(st.cfg)
    st.phases = {"start_to_logs": harness.process_seconds()}
    st.logs = common.make_logs(st.cfg, env.seed, st.tr["logs"])
    st.phases["logs"] = harness.process_seconds() - st.phases["start_to_logs"]
    st.K = online.default_ray_cells(st.scfg, st.logs[0]["range_max"])
    common.reset_peak(st.dev)
    warm = start(st, len(st.logs) - 1)
    for t in range(1, 1 + st.tr["warmup_steps"]):
        warm = step(st, warm, len(st.logs) - 1, t)[0]
    common.sync(st.dev)
    del warm
    common.settle()
    return st


def _scan(st: State, log: dict, t: int):
    r = torch.as_tensor(log["ranges"][t:t + 1], device=st.dev)
    pts, m = st.scan_ops.scans_to_points(r, log["range_min"],
                                         log["range_max"], st.scfg.lidar)
    return pts[0], m[0]


def start(st: State, i: int, k: int = 0):
    pts, m = _scan(st, st.logs[i], 0)
    return st.online.init_state(pts, m, st.scfg, n_max=st.cfg["online"]
                                ["n_max"], K=st.K, device=st.dev)


def step(st: State, state, i: int, t: int):
    log = st.logs[i]
    counts = torch.as_tensor(log["counts"][t], device=st.dev)
    gyro = torch.as_tensor(log["gyro"][t], device=st.dev)
    pts, m = _scan(st, log, t)
    state = st.online.online_step(state, counts, gyro, pts, m, st.scfg,
                                  K=st.K)
    return state, state.pose.cpu().numpy()


def outputs(state, i: int) -> dict:
    T = int(state.step)
    return {"log": i, "poses": state.poses_hist[:T + 1].cpu().numpy(),
            "logodds": state.logodds.cpu().numpy()}


def stream(st: State, seconds: float | None, n_steps: int | None):
    """Steps back to back from log 0's session for `seconds` (or n_steps).
    Returns (latencies, window seconds, final state, its log)."""
    return common.stream(st.logs, lambda i, k: start(st, i),
                         lambda state, i, t: step(st, state, i, t),
                         seconds, n_steps)


def run(env: harness.Env) -> harness.Run:
    st = setup(env)
    run = harness.Run(state=st)
    run.setup_s = harness.process_seconds()
    run.work["setup_phases"] = dict(st.phases, rest=run.setup_s - sum(
        st.phases.values()))
    n = st.tr["trace_steps"]
    if env.trace:
        lat, window_s, _, _ = stream(st, None, n)
        run.work["untraced"] = {"steps": len(lat), "window_s": window_s}
        with common.NNProbe() as probe:
            (lat, _, state, i), tr = trace.traced(
                lambda: stream(st, None, n), st.dev)
        run.trace = tr
        run.attempted = len(lat)
        m = common.map_geometry(st.cfg)
        out = outputs(state, i)
        pts, msk = common.points(st, i, torch.float64)
        T = out["poses"].shape[0] - 1
        visits = rmap.ray_visits(torch.as_tensor(out["poses"][1:],
                                                 dtype=torch.float64,
                                                 device=st.dev),
                                 pts[1:T + 1], msk[1:T + 1], m,
                                 common.lidar_geometry(st.cfg)["p_rl"])
        run.work |= {"steps": len(lat), "nn_sweeps": probe.sweeps(),
                    "k2": {"scans": T, "rays": pts.shape[1],
                           "width": m["width"], "height": m["height"],
                           "visits": visits}}
    else:
        lat, run.window_s, state, i = stream(st, env.seconds, None)
        run.attempted = len(lat)
        run.work |= {"steps": len(lat), "latencies": lat}
        out = outputs(state, i)
    run.outputs = out
    del state
    run.work["runner"] = "stream_slam"
    return run


def step_transforms(st: State, i: int, steps, dtype):
    """The reference's relative transform of each step t in `steps`: ICP of
    scan t onto scan t - 1 seeded by its odometry, in `dtype`."""
    cfg, log, dev = st.cfg, st.logs[i], st.dev
    pts, msk = common.points(st, i, dtype)
    rob, ic = cfg["robot"], cfg["icp"]
    odo = geo.odometry(log["counts"], log["gyro"], rob["dist_per_tick"],
                       rob["encoder_freq"])
    To = geo.T_of(torch.as_tensor(odo, dtype=dtype, device=dev))
    s = torch.as_tensor(np.asarray(steps), device=dev)
    T, _, _ = ricp.icp(pts[s], pts[s - 1], msk[s], msk[s - 1],
                       geo.mm(geo.inv(To[s - 1]), To[s]), ic["epsilon"],
                       ic["max_iters"], ic["stopping_thresh"],
                       ic["normalize_error"])
    return T


def judge(st: State, out: dict) -> dict:
    dev, f64 = st.dev, torch.float64
    poses = torch.as_tensor(out["poses"], device=dev).to(f64)
    T = poses.shape[0] - 1
    rng = np.random.default_rng([abs(st.env.seed), 7])
    steps = common.sample(rng, list(range(1, T + 1)),
                          st.tr["judge_steps"], always=(1, T))
    rel = step_transforms(st, out["log"], steps, f64)
    s = torch.as_tensor(steps, device=dev)
    want = geo.pose_of(geo.mm(geo.T_of(poses[s - 1]), rel))
    vals = _stats("step_gap", geo.pose_gap(want, poses[s]))
    pts, msk = common.points(st, out["log"], f64)
    grid = rmap.build(poses, pts[:T + 1], msk[:T + 1],
                      common.map_geometry(st.cfg),
                      common.lidar_geometry(st.cfg)["p_rl"])
    prog = torch.as_tensor(out["logodds"], device=dev).to(f64)
    map_cells = (float(((grid - prog).abs() > 1e-3).sum())
                 if grid.shape == prog.shape else float("inf"))
    vals["map_cells"] = map_cells
    return vals
