"""Offline runner: whole logs through the program's run_slam, back to
back, closed loop, each call from the host's numpy log (its upload
included) to the results on the host.

The judge holds one completed run, drawn from the seed, to the plain
reference in float64:
  sm_gap      the widest gap (metres + radians) between the program's and
              the reference's scan-matching transform of a consecutive
              pair; the reference runs its own ICP from the raw ranges and
              its own odometry; sm_gap_p99 the 99th percentile of those
              gaps (about the 50th widest of 4,955: a fault confined to
              one chunk of 64 pairs reaches it) and sm_gap_median;
  loop_gap    the widest gap between the two loop-closure transforms of a
              pair (reference ICP from identity, normalized error), over
              every pair, accepted or not;
  loop_flips  loop pairs whose accept flag differs;
  pg_excess   the program's optimized poses' cost, in the pose graph of the
              program's own scan-matching transforms and accepted loops
              (the program's input to its solver), above that graph's
              optimum as the reference solves it, over max(optimum, 1):
              it judges the solve; sm_gap and loop_gap judge its input;
  map_cells   cells of the program's log-odds map more than 1e-3 from the
              reference's map painted at the program's optimized poses.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import common
import harness
import trace
from reference import geometry as geo
from reference import icp as ricp
from reference import mapping as rmap
from reference import posegraph as rpg
from reference.geometry import gap_stats as _stats


class State:
    pass


def setup(env: harness.Env) -> State:
    import lidar_slam_tpu_torch.models.slam as slam

    st = State()
    st.env, st.cfg, st.tr = env, env.cell.config, env.cell.traffic
    st.dev = torch.device(env.device)
    st.slam = slam
    st.scfg = common.slam_config(st.cfg)
    st.phases = {"start_to_logs": harness.process_seconds()}
    st.logs = common.make_logs(st.cfg, env.seed, st.tr["logs"])
    st.phases["logs"] = harness.process_seconds() - st.phases["start_to_logs"]
    st.loops = []
    orig = slam.compute_loop_closures

    def recording(*a, **k):  # keeps the loop transforms for the judge
        out = orig(*a, **k)
        st.loops.append(out[0])
        return out

    slam.compute_loop_closures = recording
    common.reset_peak(st.dev)
    for w in range(st.tr["warmup_logs"]):
        one(st, len(st.logs) - 1 - w % len(st.logs))
    common.sync(st.dev)
    st.loops.clear()
    common.settle()
    return st


def one(st: State, i: int):
    log = st.logs[i]
    res = st.slam.run_slam(
        log["counts"], log["gyro"], log["ranges"], log["range_min"],
        log["range_max"], mode=st.tr["mode"],
        fixed_interval=st.cfg["loops"]["fixed_interval"], cfg=st.scfg,
        chunk_size=st.cfg["chunk_size"], device=st.dev)
    return res


def outputs(st: State, i: int, res, loop_T) -> dict:
    return {"log": i, "sm_rel": res.relative_poses_scan_matching,
            "loop_T": loop_T.cpu().numpy(), "accept": res.loop_accept,
            "poses_opt": res.poses_optimized, "logodds": res.logodds,
            "sm_iters": res.scan_matching_iters}


def run(env: harness.Env) -> harness.Run:
    st = setup(env)
    run = harness.Run(state=st)
    run.setup_s = harness.process_seconds()
    run.work["setup_phases"] = dict(st.phases, rest=run.setup_s - sum(
        st.phases.values()))
    n_scans = st.logs[0]["ranges"].shape[0]
    if env.trace:
        res = one(st, 0)
        stages = dict(res.stage_seconds)
        st.loops.clear()
        with common.NNProbe() as probe:
            res, tr = trace.traced(lambda: one(st, 0), st.dev)
        run.trace = tr
        run.attempted = 1
        run.outputs = outputs(st, 0, res, st.loops[-1])
        m = common.map_geometry(st.cfg)
        lg = common.lidar_geometry(st.cfg)
        pts, msk = common.points(st, 0, torch.float64)
        visits = rmap.ray_visits(
            torch.as_tensor(res.poses_optimized, dtype=torch.float64,
                            device=st.dev), pts, msk, m, lg["p_rl"])
        run.work |= {"stage_seconds": [stages], "nn_sweeps": probe.sweeps(),
                    "k1": {"scans": n_scans, "rays": pts.shape[1],
                           "width": m["width"], "height": m["height"],
                           "visits": visits}}
    else:
        done = []
        t0 = time.perf_counter()
        while True:
            i = len(done) % len(st.logs)
            done.append((i, one(st, i), st.loops[-1]))
            if time.perf_counter() - t0 >= env.seconds:
                break
        run.window_s = time.perf_counter() - t0
        run.attempted = len(done)
        run.work |= {"scans": n_scans * len(done),
                    "stage_seconds": [r.stage_seconds for _, r, _ in done]}
        pick = np.random.default_rng(abs(env.seed)).integers(len(done))
        run.outputs = outputs(st, *done[pick])
        del done
    run.work["runner"] = "offline"
    st.loops.clear()
    return run


def _compose(rel: np.ndarray) -> np.ndarray:
    """Poses (N, 3) of the chain of (N - 1, 3, 3) relative transforms from
    the origin."""
    T = np.eye(3)
    out = [np.zeros(3)]
    for R in rel:
        T = T @ R
        out.append(np.array([T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])]))
    return np.stack(out)


def pipeline(st: State, i: int, dtype, full: bool = True) -> dict:
    """The reference's own run of log i in `dtype`: scan matching, loop
    closures and their gates; with `full`, the pose graph from the
    scan-matched poses and the map at the optimized poses. The judge's
    reference in float64 (without `full`); the control (control.py) in
    float32 with TF32 matmuls."""
    cfg, log, dev = st.cfg, st.logs[i], st.dev
    pts, msk = common.points(st, i, dtype)
    rob = cfg["robot"]
    odo = torch.as_tensor(geo.odometry(log["counts"], log["gyro"],
                                       rob["dist_per_tick"],
                                       rob["encoder_freq"]),
                          dtype=dtype, device=dev)
    To = geo.T_of(odo)
    ic = cfg["icp"]
    T_sm, _, sm_iters = ricp.icp(pts[1:], pts[:-1], msk[1:], msk[:-1],
                          geo.mm(geo.inv(To[:-1]), To[1:]), ic["epsilon"],
                          ic["max_iters"], ic["stopping_thresh"],
                          ic["normalize_error"])
    lc = cfg["loops"]
    n = pts.shape[0]
    li = torch.arange(0, n - lc["fixed_interval"], lc["fixed_interval"],
                      device=dev)
    lj = li + lc["fixed_interval"]
    eye = torch.eye(3, dtype=dtype, device=dev).expand(li.numel(), 3, 3)
    T_lp, _, _ = ricp.icp(pts[li], pts[lj], msk[li], msk[lj], eye,
                          lc["epsilon"], lc["max_iters"],
                          lc["stopping_thresh"], lc["normalize_error"])
    counts = np.asarray(log["counts"], np.float64)
    max_d = np.max((counts[:, 0] + counts[:, 1]) / 2 * rob["dist_per_tick"])
    max_yaw = np.degrees(np.max(np.abs(np.asarray(log["gyro"], np.float64)
                                       [:, 2])) / rob["encoder_freq"])
    yaw = torch.rad2deg(torch.atan2(T_lp[:, 1, 0], T_lp[:, 0, 0]))
    acc = (torch.linalg.vector_norm(T_lp[:, :2, 2], dim=-1) < max_d) & (
        yaw < max_yaw)
    out = {"log": i, "sm_rel": T_sm, "loop_T": T_lp, "accept": acc,
           "sm_iters": sm_iters}
    if full:
        pg = cfg["pose_graph"]
        g = rpg.Graph(T_sm, li[acc], lj[acc], T_lp[acc], pg["prior_sigmas"],
                      pg["between_sigmas"], pg["loop_sigmas"])
        x0 = torch.as_tensor(_compose(T_sm.double().cpu().numpy()),
                             dtype=dtype, device=dev)
        out["poses_opt"], _ = rpg.optimize(g, x0)
        out["logodds"] = rmap.build(out["poses_opt"], pts, msk,
                                    common.map_geometry(cfg),
                                    common.lidar_geometry(cfg)["p_rl"])
    return out


def judge(st: State, out: dict) -> dict:
    dev, f64 = st.dev, torch.float64
    cfg = st.cfg

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(f64)

    ref = pipeline(st, out["log"], f64, full=False)
    gaps = geo.pose_gap(geo.pose_of(ref["sm_rel"]),
                        geo.pose_of(t(out["sm_rel"])))
    vals = _stats("sm_gap", gaps)
    worst = int(torch.argmax(gaps))
    vals["sm_worst_pair"] = worst
    vals["sm_worst_iters"] = [int(np.asarray(out["sm_iters"])[worst]),
                              int(ref["sm_iters"][worst])]
    vals["sm_pairs_iters_differ"] = int(
        (t(out["sm_iters"]) != ref["sm_iters"].to(f64)).sum())
    vals["sm_pairs_over_1mm"] = int((gaps > 1e-3).sum())
    vals.update(_stats("loop_gap", geo.pose_gap(
        geo.pose_of(ref["loop_T"]), geo.pose_of(t(out["loop_T"])))))
    acc_p = t(out["accept"]).bool()
    acc_r = ref["accept"]
    vals["loop_flips"] = int((acc_p != acc_r).sum())
    vals["loops_accepted"] = int(acc_p.sum())
    # the pose graph of the program's own scan matching and loops, solved
    # to convergence: the program's optimized poses against its optimum
    pg = cfg["pose_graph"]
    fi = cfg["loops"]["fixed_interval"]
    rel = t(out["sm_rel"])
    li = torch.arange(0, rel.shape[0] + 1 - fi, fi, device=dev)
    g = rpg.Graph(rel, li[acc_p], li[acc_p] + fi, t(out["loop_T"])[acc_p],
                  pg["prior_sigmas"], pg["between_sigmas"], pg["loop_sigmas"])
    x_opt, c_opt = rpg.optimize(
        g, torch.as_tensor(_compose(rel.cpu().numpy()), device=dev))
    x_prog = t(out["poses_opt"])
    vals["pg_excess"] = (g.cost(x_prog) - c_opt) / max(c_opt, 1.0)
    vals["pg_gap"] = float(geo.pose_gap(x_prog, x_opt).max())
    pts, msk = common.points(st, out["log"], f64)
    grid = rmap.build(x_prog, pts, msk, common.map_geometry(cfg),
                      common.lidar_geometry(cfg)["p_rl"])
    prog_map = t(out["logodds"])
    vals["map_cells"] = (float(((grid - prog_map).abs() > 1e-3).sum())
                         if grid.shape == prog_map.shape else float("inf"))
    return vals
