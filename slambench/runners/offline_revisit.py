"""Offline runner of the revisit deployment (main.py --mode gtsam
--loop_proposer descriptor --robust_loss huber): the offline runner's work
(runners/offline.py: whole logs through the program's run_slam, back to
back, closed loop, each call from the host's numpy log to the results on
the host) on two-lap logs (synth_revisit), with the configuration's
descriptor proposer and Huber loop factors. Once a revisit is kept,
run_slam solves the pose graph with its direct solver; on the card the
configuration takes that solver's step in float64, and set-up refuses a
program that takes it in float32 (require_float64_direct_step).

Its state runs offline.one, and its traffic's runner kind is "offline",
so that control.py, spans.py and every metric that reads an offline run
read this one as well.

The judge holds one completed run, drawn from the seed, to the plain
reference in float64 (reference/revisit.py beside offline.pipeline's
scan matching and loops):
  sm_gap_p99, sm_gap_median, loop_gap_p99, loop_gap_median, loop_flips
                  offline.judge's numbers (the widest gaps, sm_gap and
                  loop_gap, beside them with no limit);
  proposal_flips  pairs in one proposed set and not the other, the
                  program's against the reference's proposer;
  verify_flips    proposals of the program whose accept flag differs from
                  the reference's verification of the same pair;
  kept_flips      pairs in one kept set and not the other, the program's
                  against the reference's whole revisit stage;
  revisit_gap_p99, revisit_gap_median   |dt| m + |dyaw| rad between the
                  program's kept revisit measurements and the reference's
                  (its ICP of the same pairs, inverted);
  pg_excess       the program's optimized poses' Huber cost, in the pose
                  graph of the program's own scan-matching transforms,
                  accepted fixed loops and kept revisits (the program's
                  input to its solver), above that graph's optimum as the
                  reference's Huber LM reaches it (the lower of its runs
                  from the scan-matched poses and from the ground truth,
                  neither of them the program's optimized poses), over
                  max(optimum, 1);
  pg_gap          the widest |dt| m + |dyaw| rad between the program's
                  optimized poses and that optimum's: a program that stops
                  in another basin of the graph, even one of a cost near
                  the optimum's, is far from it;
  map_cells       cells of the program's map more than 1e-3 from the
                  reference's map painted at the program's optimized poses;
and reports, with no limit: revisits_kept, revisits_proposed,
huber_outside (the loop factors beyond the Huber width at the program's
optimized poses: where there are none, the Huber cost is least squares
near them), lm_iterations, woodbury_columns (the most right-hand sides
the program handed its block_tridiag_solve in the log: 1 + 3 x (fixed
candidates + kept revisits) on the direct solver, 1 on the banded), and
ate_optimized and ate_scan_matching, the RMSE in metres of the program's
optimized and scan-matching positions from the ground truth's (both
start at the origin heading along +x, in one frame), which show whether
the revisits move the trajectory.

A traced run makes one log four times, as the filtered runner's does
(runners/offline_filtered.py): (a) untraced, for run_slam's stage
seconds; (b) under torch.profiler (run.trace, the judged outputs, the
sweeps and ray visits of the K4 and K1 rooflines, and the K6 roofline's
calls: (n, b, m, q, bytes an element) of each panel the program handed
its block_tridiag_solve, as recorded); (c) and (d) with the program's tracing on, kept in
run.work[spans.KEY].
"""

from __future__ import annotations

import functools
import inspect
import time

import numpy as np
import torch

import common
import harness
import synth_revisit
import trace
from reference import geometry as geo
from reference import mapping as rmap
from reference import posegraph as rpg
from reference import revisit as rrev

offline = harness.load_module("runners", "offline")
filtered = harness.load_module("runners", "offline_filtered")
KIND = "offline"  # the runner kind that control.py and spans.py run
one = offline.one


def make_log(config: dict, seed: int) -> dict:
    """One two-lap log at the configuration's shapes, as common.make_log
    makes the room's: float32 as a sensor log stores it, the ground truth
    float64."""
    p = dict(config["log"])
    gen = p.pop("generator")
    if gen != "revisit_dataset":
        raise ValueError(f"unknown log generator {gen!r}")
    d = synth_revisit.synthetic_revisit_dataset(seed=seed, **p)
    return {"counts": d["encoder"]["counts"].astype(np.float32),
            "gyro": d["imu"]["angular_velocity"].astype(np.float32),
            "ranges": d["lidar"]["ranges"].astype(np.float32),
            "gt": d["ground_truth"],
            "range_min": float(p["range_min"]),
            "range_max": float(p["range_max"])}


def _recording_call(module, name: str, pick):
    """module.<name>, wrapped once a process so that pick(args, kwargs,
    out) of each call is appended to the list at the wrapper's
    `record_to`."""
    fn = getattr(module, name)
    if not hasattr(fn, "record_to"):
        orig = fn

        @functools.wraps(orig)
        def fn(*a, **k):
            out = orig(*a, **k)
            fn.record_to.append(pick(a, k, out))
            return out
        setattr(module, name, fn)
    return fn


def _k6_call(q_default: int):
    """The pick of a call of the program's block_tridiag_solve (K6 on the
    card): (n, b, m, q, itemsize) of what it was handed, A's n blocks of b
    x b, R's m right-hand sides, the segment length and R's element
    size."""
    def pick(a, k, out):
        A, R = a[0], a[2]
        q = k.get("q", a[3] if len(a) > 3 else q_default)
        return (A.shape[0], A.shape[-1], R.shape[-1], int(q),
                R.element_size())
    return pick


def require_float64_direct_step(dev: torch.device, k6_calls) -> None:
    """Refuses, before any timed log, a program that takes the direct LM
    step in float32 on the card, where the configuration's precision asks
    for float64: in float32 the Woodbury panels and the capacitance solve
    of these logs' revisit arcs, thousands of poses long, stop the LM up
    to 6.5% of the cost above the optimum, which pg_excess does not admit.
    The step's precision is read from the element size of each panel the
    warm-up handed block_tridiag_solve at the direct shape (m > 1): 8 bytes
    in float64. The banded solve (m = 1) and CPU runs are not held to it."""
    if dev.type != "cuda":
        return
    sizes = sorted({c[4] for c in k6_calls if c[2] > 1 and c[4] < 8})
    if sizes:
        raise SystemExit(
            "no result: this configuration takes the direct LM step in "
            "float64 on the card, and the program handed its "
            f"block_tridiag_solve Woodbury panels of {sizes} bytes an "
            "element")


def setup(env: harness.Env):
    import lidar_slam_tpu_torch.models.pose_graph as pose_graph
    import lidar_slam_tpu_torch.models.slam as slam

    st = offline.State()
    st.env, st.cfg = env, env.cell.config
    st.tr = dict(env.cell.traffic, runner=KIND)
    st.dev = torch.device(env.device)
    st.scfg = common.slam_config(st.cfg)
    st.phases = {"start_to_logs": harness.process_seconds()}
    st.logs = [make_log(st.cfg, s)
               for s in common.log_seeds(env.seed, st.tr["logs"])]
    st.phases["logs"] = harness.process_seconds() - st.phases["start_to_logs"]
    # the fixed loops' transforms, the verified proposals (their pairs,
    # accept flags and keep mask), the kept measurements and the K6 calls'
    # shapes, for the judge and the K6 roofline
    st.loops, st.verified, st.revisits, st.k6 = [], [], [], []
    st.keeps = []  # the filter's masks, which filtered.forget clears
    filtered._recording(slam, "compute_loop_closures",
                        lambda out: out[0]).record_to = st.loops
    _recording_call(slam, "suppress_verified_pairs",
                    lambda a, k, keep: (a[0], a[1], a[3], keep)
                    ).record_to = st.verified
    filtered._recording(slam, "revisit_closures",
                        lambda rv: rv.meas).record_to = st.revisits
    solve = pose_graph.block_tridiag_solve
    q = inspect.signature(getattr(solve, "__wrapped__", solve)
                          ).parameters["q"].default
    _recording_call(pose_graph, "block_tridiag_solve",
                    _k6_call(q)).record_to = st.k6
    st.slam = slam
    common.reset_peak(st.dev)
    for w in range(st.tr["warmup_logs"]):
        one(st, len(st.logs) - 1 - w % len(st.logs))
    common.sync(st.dev)
    require_float64_direct_step(st.dev, st.k6)
    forget(st)
    common.settle()
    return st


def forget(st) -> None:
    for records in (st.loops, st.verified, st.revisits, st.k6):
        records.clear()


def outputs(st, i: int, res, loop_T, revisit=None) -> dict:
    """offline.outputs with the program's revisit stage, `revisit` =
    (verified, meas, k6) as _last gives them (by default those of the run
    just made): its proposals, their accept flags, the kept pairs and
    measurements (none where it proposed nothing), its LM iterations and
    the right-hand sides it handed K6 (the most of any call; 1 + 3L on the
    direct solver)."""
    out = offline.outputs(st, i, res, loop_T)
    verified, meas, k6 = _last(st)[1:] if revisit is None else revisit
    if verified is None:
        empty = np.zeros(0, np.int64)
        li = lj = empty
        acc = keep = np.zeros(0, bool)
    else:
        li, lj, acc, keep = (np.asarray(a) for a in verified)
    out |= {"proposed_i": li.astype(np.int64), "proposed_j":
            lj.astype(np.int64), "verify_accept": acc.astype(bool),
            "kept_i": li[keep].astype(np.int64),
            "kept_j": lj[keep].astype(np.int64),
            "kept_meas": (np.zeros((0, 3, 3)) if meas is None
                          else meas.cpu().numpy()),
            "lm_iterations": res.lm_iterations,
            "woodbury_columns": max((c[2] for c in k6), default=0)}
    return out


def _last(st):
    """The records of the run just made: its fixed loops, verified
    proposals, kept measurements and K6 calls."""
    return (st.loops[-1], st.verified[-1] if st.verified else None,
            st.revisits[-1] if st.revisits else None, list(st.k6))


def run(env: harness.Env) -> harness.Run:
    st = setup(env)
    run = harness.Run(state=st)
    run.setup_s = harness.process_seconds()
    run.work["setup_phases"] = dict(st.phases, rest=run.setup_s - sum(
        st.phases.values()))
    run.work["runner"] = KIND
    n_scans = st.logs[0]["ranges"].shape[0]
    if env.trace:
        stages = dict(one(st, 0).stage_seconds)
        forget(st)
        with common.NNProbe() as probe:
            res, events, host_s = filtered.profiled(lambda: one(st, 0),
                                                    st.dev)
        k6 = list(st.k6)
        run.trace = trace.reduce(events)
        run.trace["host_window_s"] = host_s
        del events
        run.attempted = 1
        run.outputs = outputs(st, 0, res, st.loops[-1])
        m = common.map_geometry(st.cfg)
        pts, valid = common.points(st, 0, torch.float64)
        visits = rmap.ray_visits(
            torch.as_tensor(res.poses_optimized, dtype=torch.float64,
                            device=st.dev), pts, valid, m,
            common.lidar_geometry(st.cfg)["p_rl"])
        forget(st)
        run.work |= {
            "stage_seconds": [stages], "nn_sweeps": probe.sweeps(),
            "k1": {"scans": n_scans, "rays": pts.shape[1],
                   "width": m["width"], "height": m["height"],
                   "visits": visits},
            "k6": k6}
        filtered.program_passes(run)
        forget(st)
    else:
        rng = np.random.default_rng(abs(env.seed))
        stages, pick = [], None
        t0 = time.perf_counter()
        while True:
            i = len(stages) % len(st.logs)
            res = one(st, i)
            stages.append(res.stage_seconds)
            if rng.integers(len(stages)) == 0:  # each log alike likely
                loop_T, *revisit = _last(st)
                pick = (i, res, loop_T, revisit)
            forget(st)
            if time.perf_counter() - t0 >= env.seconds:
                break
        run.window_s = time.perf_counter() - t0
        run.attempted = len(stages)
        run.work |= {"scans": n_scans * len(stages),
                     "stage_seconds": stages}
        run.outputs = outputs(st, *pick)
    return run


def _graph(cfg: dict, rel, li, lj, meas) -> rrev.RobustGraph:
    """The robust graph of between transforms rel (N - 1, 3, 3) and loop
    factors (li, lj, meas) under the configuration's sigmas and Huber
    width."""
    pg = cfg["pose_graph"]
    return rrev.RobustGraph(
        rpg.Graph(rel, li, lj, meas, pg["prior_sigmas"], pg["between_sigmas"],
                  pg["loop_sigmas"]), pg["robust_delta"])


def pipeline(st, i: int, dtype, full: bool = True) -> dict:
    """The reference's own run of log i in `dtype`: offline.pipeline's scan
    matching and fixed loops; with `full`, the revisit stage, the Huber
    pose graph of the scan-matching transforms, the accepted fixed loops
    and the kept revisits from the scan-matched poses, and the map at the
    optimized poses: the control's outputs (control.py).
    control.control_outputs passes on only the offline runner's keys, so
    the revisit stage is also kept as st.control_revisit, which the judge
    reads for outputs without one."""
    out = offline.pipeline(st, i, dtype, full=False)
    if not full:
        return out
    cfg, dev = st.cfg, st.dev
    pts, msk = common.points(st, i, dtype)
    log = st.logs[i]
    ranges = torch.as_tensor(log["ranges"], device=dev).to(dtype)
    rv = rrev.revisits(pts, msk, ranges, msk, log["range_min"],
                       log["range_max"], cfg["loops"], cfg["pose_graph"])
    fi = cfg["loops"]["fixed_interval"]
    li = torch.arange(0, pts.shape[0] - fi, fi, device=dev)[out["accept"]]
    g = _graph(cfg, out["sm_rel"],
               torch.cat([li, torch.as_tensor(rv["kept_i"], device=dev)]),
               torch.cat([li + fi, torch.as_tensor(rv["kept_j"],
                                                   device=dev)]),
               torch.cat([out["loop_T"][out["accept"]], rv["kept_meas"]]))
    x0 = torch.as_tensor(offline._compose(out["sm_rel"].double().cpu()
                                          .numpy()), dtype=dtype, device=dev)
    out["poses_opt"], _ = rrev.optimize(g, x0)
    out["logodds"] = rmap.build(out["poses_opt"], pts, msk,
                                common.map_geometry(cfg),
                                common.lidar_geometry(cfg)["p_rl"])
    st.control_revisit = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                              else v) for k, v in rv.items()}
    return out


def optimum(g: rrev.RobustGraph, *starts):
    """(poses, cost) of the lowest optimum the reference's Huber LM reaches
    on g from each of `starts`, none of them the program's optimized
    poses: the graph is not convex (the rotations), and from one start the
    LM can end in another basin than from another."""
    return min((rrev.optimize(g, x) for x in starts), key=lambda r: r[1])


def _pairs(li, lj) -> set:
    return set(zip(np.asarray(li).tolist(), np.asarray(lj).tolist()))


def _ate(poses, gt) -> float:
    """RMSE in metres of the positions from the ground truth's."""
    d = np.asarray(poses, np.float64)[:, :2] - np.asarray(gt)[:, :2]
    return float(np.sqrt((d * d).sum(-1).mean()))


def judge(st, out: dict) -> dict:
    dev, f64, cfg = st.dev, torch.float64, st.cfg
    pg = cfg["pose_graph"]
    i = out["log"]
    rv = out if "kept_i" in out else st.control_revisit
    log = st.logs[i]

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(f64)

    def idx(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    # scan matching and the fixed loops, as offline.judge reads them
    ref = offline.pipeline(st, i, f64, full=False)
    vals = offline._stats("sm_gap", geo.pose_gap(
        geo.pose_of(ref["sm_rel"]), geo.pose_of(t(out["sm_rel"]))))
    vals.update(offline._stats("loop_gap", geo.pose_gap(
        geo.pose_of(ref["loop_T"]), geo.pose_of(t(out["loop_T"])))))
    acc_p = t(out["accept"]).bool()
    vals["loop_flips"] = int((acc_p != ref["accept"]).sum())
    vals["loops_accepted"] = int(acc_p.sum())
    # the revisit stage: the reference's own, and its verification of
    # every pair either side proposed
    pts, msk = common.points(st, i, f64)
    ranges = torch.as_tensor(log["ranges"], device=dev).to(f64)
    r_li, r_lj = rrev.propose(ranges, msk, log["range_min"],
                              log["range_max"], pg)
    p_pairs, r_pairs = (_pairs(rv["proposed_i"], rv["proposed_j"]),
                        _pairs(r_li, r_lj))
    vals["proposal_flips"] = len(p_pairs ^ r_pairs)
    union = sorted(p_pairs | r_pairs)
    T_u, err_u, acc_u = (rrev.verify(pts, msk, [a for a, _ in union],
                                     [b for _, b in union], cfg["loops"], pg)
                         if union else (None, None, None))
    at = {p: k for k, p in enumerate(union)}
    acc_u = None if acc_u is None else acc_u.cpu().numpy()
    vals["verify_flips"] = sum(
        bool(a) != bool(acc_u[at[p]]) for p, a in zip(
            zip(np.asarray(rv["proposed_i"]).tolist(),
                np.asarray(rv["proposed_j"]).tolist()), rv["verify_accept"]))
    r_at = [at[p] for p in zip(r_li.tolist(), r_lj.tolist())]
    r_keep = (rrev.suppress(r_li, r_lj, err_u.cpu().numpy()[r_at],
                            acc_u[r_at], int(pg["proximity_suppress"]))
              if r_at else np.zeros(0, bool))
    k_pairs = list(zip(np.asarray(rv["kept_i"]).tolist(),
                       np.asarray(rv["kept_j"]).tolist()))
    vals["kept_flips"] = len(set(k_pairs) ^ _pairs(r_li[r_keep],
                                                    r_lj[r_keep]))
    if k_pairs:
        meas_r = geo.inv(T_u[torch.as_tensor([at[p] for p in k_pairs],
                                             device=dev)])
        gaps = geo.pose_gap(geo.pose_of(meas_r),
                            geo.pose_of(t(rv["kept_meas"])))
        vals.update(offline._stats("revisit_gap", gaps))
    else:
        vals.update(revisit_gap=0.0, revisit_gap_p99=0.0,
                    revisit_gap_median=0.0)
    # the program's own graph, solved to convergence under the Huber cost
    fi = cfg["loops"]["fixed_interval"]
    rel = t(out["sm_rel"])
    li = torch.arange(0, rel.shape[0] + 1 - fi, fi, device=dev)[acc_p]
    g = _graph(cfg, rel, torch.cat([li, idx(rv["kept_i"])]),
               torch.cat([li + fi, idx(rv["kept_j"])]),
               torch.cat([t(out["loop_T"])[acc_p],
                          t(rv["kept_meas"]).reshape(-1, 3, 3)]))
    x_prog = t(out["poses_opt"])
    x_opt, c_opt = optimum(g, torch.as_tensor(
        offline._compose(rel.cpu().numpy()), device=dev), t(log["gt"]))
    vals["pg_excess"] = (g.cost(x_prog) - c_opt) / max(c_opt, 1.0)
    vals["huber_outside"] = g.outside(x_prog)
    vals["pg_gap"] = float(geo.pose_gap(x_prog, x_opt).max())
    grid = rmap.build(x_prog, pts, msk, common.map_geometry(cfg),
                      common.lidar_geometry(cfg)["p_rl"])
    prog_map = t(out["logodds"])
    vals["map_cells"] = (float(((grid - prog_map).abs() > 1e-3).sum())
                         if grid.shape == prog_map.shape else float("inf"))
    kept = len(k_pairs)
    vals |= {"revisits_kept": kept,
             "revisits_proposed": len(rv["proposed_i"]),
             "ate_optimized": _ate(out["poses_opt"], log["gt"]),
             "ate_scan_matching": _ate(offline._compose(
                 np.asarray(out["sm_rel"], np.float64)), log["gt"])}
    for k in ("lm_iterations", "woodbury_columns"):
        if k in out:
            vals[k] = int(out[k])
    return vals
