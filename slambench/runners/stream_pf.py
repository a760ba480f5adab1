"""Particle-filter localization runner: one step at a time through the
program's particle_filter.pf_step against a map that set-up builds with
the program's map build (K1) over the log's ground-truth poses, the
robot localizing in a map of an earlier drive; closed loop, cycling the
logs, a new filter at the origin at each log's start (not a step). A step
starts from the host's (counts, gyro, ranges) row and ends with its
estimate on the host. Each session's filter draws its motion noise and
resampling offsets from its own generator, as pf_step does for a user,
seeded from --seed and the session's number.

The judge replays those draws: a generator seeded as the session's,
drawing as pf_step draws (standard normals for the speed and the yaw
rate of every particle, then one uniform, a step). It holds the program
to the plain reference's whole step in float64 from the program's own
particles and log-weights before the step (the resampling makes two
sound runs part ways), over steps sampled from the seed, each log's first
step judged from the reference's own start:
  est_gap      the widest gap (metres + radians) between the program's
               estimate and the reference's, the reference scoring
               against its own map of the log's ground truth; also its
               median;
  state_split  the mean over those steps of the weight on which the
               state the program hands to the next step and the
               reference's disagree: half the summed weight differences,
               plus the weight on particles more than 1e-4 apart
               (0 when they agree, 1 when no particle does). It judges
               the motion, the normalised weights and the systematic
               resample, which the estimate precedes.
"""

from __future__ import annotations

import numpy as np
import torch

import common
import harness
import trace
from reference import geometry as geo
from reference import mapping as rmap
from reference.geometry import gap_stats as _stats
from reference import pf as rpf

APART = 1e-4  # metres + radians: particles further apart disagree
WARMUP = 2**20  # the warm-up's session number, apart from the window's


class State:
    pass


def setup(env: harness.Env) -> State:
    from lidar_slam_tpu_torch.models import occupancy
    from lidar_slam_tpu_torch.models import particle_filter as pfm
    from lidar_slam_tpu_torch.models.odometry import v_from_encoder
    from lidar_slam_tpu_torch.ops import scan as scan_ops

    st = State()
    st.env, st.cfg, st.tr = env, env.cell.config, env.cell.traffic
    st.dev = dev = torch.device(env.device)
    st.pfm, st.scan_ops, st.v_from_encoder = pfm, scan_ops, v_from_encoder
    st.scfg = common.slam_config(st.cfg)
    st.pcfg = pfm.PFConfig(**st.cfg["pf"])
    st.phases = {"start_to_logs": harness.process_seconds()}
    st.logs = common.make_logs(st.cfg, env.seed, st.tr["logs"])
    st.phases["logs"] = harness.process_seconds() - st.phases["start_to_logs"]
    common.reset_peak(dev)
    for log in st.logs:
        r = torch.as_tensor(log["ranges"], device=dev)
        pts, m = scan_ops.scans_to_points(r, log["range_min"],
                                          log["range_max"], st.scfg.lidar)
        K = occupancy.adaptive_ray_cells(pts, m, st.scfg.map,
                                         log["range_max"])
        gt = torch.as_tensor(log["gt"], dtype=torch.float32, device=dev)
        lo = occupancy.build_logodds(gt, pts, m, st.scfg.map, K)
        log["im"] = (lo > 0).to(torch.float32)
        del pts, m, lo
    warm = start(st, len(st.logs) - 1, WARMUP)
    for t in range(1, 1 + st.tr["warmup_steps"]):
        warm = step(st, warm, len(st.logs) - 1, t)[0]
    common.sync(dev)
    common.settle()
    return st


def session_seed(st: State, k: int) -> int:
    """The seed of session k's generator, drawn from --seed."""
    ss = np.random.SeedSequence([abs(int(st.env.seed)), 13, k])
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def start(st: State, i: int, k: int):
    return st.pfm.init_pf_state(st.pcfg, torch.zeros(3),
                                seed=session_seed(st, k), device=st.dev)


def step(st: State, state, i: int, t: int):
    log = st.logs[i]
    counts = torch.as_tensor(log["counts"][t], device=st.dev)
    gyro = torch.as_tensor(log["gyro"][t], device=st.dev)
    r = torch.as_tensor(log["ranges"][t:t + 1], device=st.dev)
    pts, m = st.scan_ops.scans_to_points(r, log["range_min"],
                                         log["range_max"], st.scfg.lidar)
    state, (est, _, _) = st.pfm.pf_step(
        state, st.v_from_encoder(counts), gyro[-1], pts[0], m[0], log["im"],
        st.scfg.map, st.pcfg)
    return state, est.cpu().numpy()


def stream(st: State, seconds: float | None, n_steps: int | None):
    """Steps back to back from log 0 for `seconds` (or n_steps). Returns
    (latencies, window seconds, records): a record per step, (log, t,
    session, particles and log-weights before the step and after it,
    estimate), holding the program's tensors."""
    rec = []

    def keep(i, t, k, before, after, est):
        rec.append((i, t, k, before.particles, before.logw, after.particles,
                    after.logw, est))

    lat, window, _, _ = common.stream(
        st.logs, lambda i, k: start(st, i, k),
        lambda state, i, t: step(st, state, i, t), seconds, n_steps, keep)
    return lat, window, rec


def outputs(st: State, rec: list) -> dict:
    """The records of the steps the judge samples, on the host."""
    rng = np.random.default_rng([abs(st.env.seed), 11])
    firsts = [k for k, r in enumerate(rec) if r[1] == 1]
    keep = common.sample(rng, list(range(len(rec))), st.tr["judge_steps"],
                         always=firsts[:1] + [len(rec) - 1])
    return {"records": [r[:3] + tuple(a.cpu().numpy() for a in r[3:7])
                        + (r[7],) for r in (rec[k] for k in keep)]}


def run(env: harness.Env) -> harness.Run:
    st = setup(env)
    run = harness.Run(state=st)
    run.setup_s = harness.process_seconds()
    run.work["setup_phases"] = dict(st.phases, rest=run.setup_s - sum(
        st.phases.values()))
    if env.trace:
        n = st.tr["trace_steps"]
        stream(st, None, n)
        (lat, _, rec), tr = trace.traced(lambda: stream(st, None, n),
                                         st.dev)
        run.trace = tr
        run.work |= {"steps": len(lat)}
    else:
        lat, run.window_s, rec = stream(st, env.seconds, None)
        run.work |= {"steps": len(lat), "latencies": lat}
    run.attempted = len(lat)
    run.outputs = outputs(st, rec)
    del rec
    run.work["runner"] = "stream_pf"
    return run


def draws(st: State, steps) -> dict:
    """{(session, t): (eps_v (P,), eps_w (P,), u ())}: the program's draws
    at each (session, t) of `steps`, replayed from a generator seeded as
    the session's, in pf_step's order (float32, on the device)."""
    P, dev = st.pcfg.n_particles, st.dev
    f32 = dict(dtype=torch.float32, device=dev)
    out = {}
    for k in sorted({k for k, _ in steps}):
        want = {t for kk, t in steps if kk == k}
        gen = torch.Generator(device=dev)
        gen.manual_seed(session_seed(st, k))
        for t in range(1, max(want) + 1):
            d = (torch.randn(P, generator=gen, **f32),
                 torch.randn(P, generator=gen, **f32),
                 torch.rand((), generator=gen, **f32))
            if t in want:
                out[k, t] = d
    return out


def reference_map(st: State, i: int, dtype):
    """The reference's 0/1 occupancy of log i: its own map painted at the
    log's ground-truth poses, occupied where the log-odds are positive."""
    log, dev = st.logs[i], st.dev
    pts, msk = common.points(st, i, dtype)
    gt = torch.as_tensor(log["gt"], device=dev).to(dtype)
    grid = rmap.build(gt, pts, msk, common.map_geometry(st.cfg),
                      common.lidar_geometry(st.cfg)["p_rl"])
    return (grid > 0).to(dtype), pts, msk


def reference_steps(st: State, records, dtype, maps=None):
    """The reference's whole step of each record in `dtype`, from the
    particles and log-weights before it (a log's first step from the
    reference's own start: every particle at the origin, equal weights),
    with the record's replayed draws. Returns a list of (particles,
    log-weights, estimate) after each step."""
    dev = st.dev
    maps = {} if maps is None else maps
    P = st.pcfg.n_particles
    m = common.map_geometry(st.cfg)
    rob, pf = st.cfg["robot"], st.cfg["pf"]
    noise = draws(st, [(r[2], r[1]) for r in records])
    out = []
    for i, t, k, particles, logw, *_ in records:
        if i not in maps:
            maps[i] = reference_map(st, i, dtype)
        occ, pts, msk = maps[i]
        log = st.logs[i]
        if t == 1:
            particles = torch.zeros(P, 3, dtype=dtype, device=dev)
            logw = torch.full((P,), -np.log(P), dtype=dtype, device=dev)
        else:
            particles = torch.as_tensor(particles, device=dev).to(dtype)
            logw = torch.as_tensor(logw, device=dev).to(dtype)
        counts = torch.as_tensor(log["counts"][t], device=dev).to(dtype)
        v = geo.encoder_speed(counts, rob["dist_per_tick"],
                              rob["encoder_freq"])
        w = float(log["gyro"][t, 2])
        eps_v, eps_w, u = (a.to(dtype) for a in noise[k, t])
        out.append(rpf.step(particles, logw, v, w, eps_v, eps_w, u, pts[t],
                            msk[t], occ, m, pf))
    return out


def split(p_a, lw_a, p_b, lw_b) -> torch.Tensor:
    """The weight on which two weighted particle sets, matched by index,
    disagree: half the summed weight differences plus the weight on
    particles more than APART apart."""
    wa, wb = torch.exp(lw_a), torch.exp(lw_b)
    apart = geo.pose_gap(p_a, p_b) > APART
    return (0.5 * (wa - wb).abs().sum()
            + torch.where(apart, torch.minimum(wa, wb), 0.0).sum())


def judge(st: State, out: dict) -> dict:
    rec, dev, f64 = out["records"], st.dev, torch.float64
    ref = reference_steps(st, rec, f64)

    def t(a):
        return torch.as_tensor(a, device=dev).to(f64)

    prog_est = torch.stack([t(r[7]) for r in rec])
    vals = _stats("est_gap", geo.pose_gap(torch.stack([e for _, _, e in ref]),
                                          prog_est))
    splits = torch.stack([split(t(r[5]), t(r[6]), p, lw)
                          for r, (p, lw, _) in zip(rec, ref)])
    vals["state_split"] = float(splits.mean())
    vals["state_split_max"] = float(splits.max())
    vals["resampled_share"] = float(np.mean([
        bool((lw == lw[0]).all()) for _, lw, _ in ref]))
    return vals
