"""What the runners share: the logs made from the seed, the program's
configuration built from a configuration file, the reference's map
geometry and scan points, the stream loop, and the device record of a
result."""

from __future__ import annotations

import gc
import math
import time

import numpy as np

import synth


def log_seeds(seed: int, n: int) -> list[int]:
    """n seeds for the logs of a run, drawn from --seed (any integer)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64)]


def make_log(config: dict, seed: int) -> dict:
    """One synthetic log at the configuration's shapes, float32 as a
    sensor log stores it; the ground truth float64."""
    p = dict(config["log"])
    gen = p.pop("generator")
    if gen != "synthetic_dataset":
        raise ValueError(f"unknown log generator {gen!r}")
    d = synth.synthetic_dataset(seed=seed, **p)
    return {"counts": d["encoder"]["counts"].astype(np.float32),
            "gyro": d["imu"]["angular_velocity"].astype(np.float32),
            "ranges": d["lidar"]["ranges"].astype(np.float32),
            "gt": d["ground_truth"],
            "range_min": float(p["range_min"]),
            "range_max": float(p["range_max"])}


def make_logs(config: dict, seed: int, n: int) -> list[dict]:
    return [make_log(config, s) for s in log_seeds(seed, n)]


def slam_config(config: dict):
    """The program's SlamConfig for a configuration file."""
    from lidar_slam_tpu_torch.config import (IcpConfig, LidarConfig,
                                             MapConfig, PoseGraphConfig,
                                             RobotConfig, SlamConfig)

    m = config["map"]
    lid = config["lidar"]
    pg = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["pose_graph"].items()}
    return SlamConfig(
        robot=RobotConfig(dist_per_tick=config["robot"]["dist_per_tick"],
                          encoder_freq=config["robot"]["encoder_freq"]),
        lidar=LidarConfig(n_rays=config["log"]["n_rays"],
                          angle_min_deg=lid["angle_min_deg"],
                          angle_max_deg=lid["angle_max_deg"],
                          p_rl=tuple(lid["p_rl"])),
        map=MapConfig(resolution=m["resolution"],
                      world_max_x=m["world_max_x"],
                      world_max_y=m["world_max_y"],
                      world_min_x=m["world_min_x"],
                      world_min_y=m["world_min_y"], buffer=m["buffer"],
                      logodds_clip=m["logodds_clip"]),
        icp=IcpConfig(**config["icp"]),
        pose_graph=PoseGraphConfig(**pg))


def map_geometry(config: dict) -> dict:
    """The reference's map: (world extent / resolution + buffer) cells a
    side, rounded up (reference modules/ogm.py:37-38)."""
    m = config["map"]
    res = m["resolution"]
    return {"width": int(math.ceil((m["world_max_x"] - m["world_min_x"])
                                   / res + m["buffer"])),
            "height": int(math.ceil((m["world_max_y"] - m["world_min_y"])
                                    / res + m["buffer"])),
            "resolution": res, "world_min_x": m["world_min_x"],
            "world_min_y": m["world_min_y"],
            "logodds_clip": m["logodds_clip"]}


def lidar_geometry(config: dict) -> dict:
    lid = config["lidar"]
    return {"angle_min": math.radians(lid["angle_min_deg"]),
            "angle_max": math.radians(lid["angle_max_deg"]),
            "p_rl": tuple(lid["p_rl"][:2])}


def points(st, i: int, dtype):
    """The reference's (N, R, 2) scan points and (N, R) masks of log i of
    a runner's state (its cfg, logs and dev), worked out from the raw
    ranges in `dtype`."""
    import torch

    from reference import geometry as geo

    log, lg = st.logs[i], lidar_geometry(st.cfg)
    ranges = torch.as_tensor(log["ranges"], device=st.dev).to(dtype)
    return geo.scan_points(ranges, log["range_min"], log["range_max"],
                           lg["angle_min"], lg["angle_max"], lg["p_rl"])


def stream(logs: list, start, step, seconds: float | None,
           n_steps: int | None, keep=None):
    """Steps back to back, closed loop: session 0 on log 0, and at each
    log's end a new session on the next log, cycling (start(i, k) opens
    session k on log i; it is inside the window but is not a step). A
    step is step(state, i, t) -> (state, out); keep(i, t, k, before,
    state, out), when given, records it outside the step's time. Runs for
    `seconds` (or n_steps). Returns (latencies, window seconds, last
    state, its log)."""
    n_log = logs[0]["ranges"].shape[0]
    i, k, t = 0, 0, 1
    state = start(i, k)
    lat = []
    t0 = time.perf_counter()
    while True:
        if t == n_log:
            i, k, t = (i + 1) % len(logs), k + 1, 1
            state = start(i, k)
        a = time.perf_counter()
        before = state
        state, out = step(state, i, t)
        b = time.perf_counter()
        lat.append(b - a)
        if keep is not None:
            keep(i, t, k, before, state, out)
        t += 1
        if (n_steps is not None and len(lat) >= n_steps) or (
                seconds is not None and b - t0 >= seconds):
            break
    return lat, time.perf_counter() - t0, state, i


def settle() -> None:
    """End of set-up: collect what set-up left and move every object it
    made out of the collector's later passes, so that no full collection
    of set-up's objects falls into the window."""
    gc.collect()
    gc.freeze()


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def device_record(dev, count: int = 1) -> dict:
    """The result's "device": platform, kind, count and the peak of
    allocated memory."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def sample(rng: np.random.Generator, items: list, k: int,
           always=()) -> list:
    """Up to k of items drawn from rng, in order, with `always` kept."""
    keep = set(always) & set(items)
    rest = [i for i in items if i not in keep]
    take = max(0, min(k - len(keep), len(rest)))
    pick = rng.choice(len(rest), size=take, replace=False) if take else []
    return sorted(keep | {rest[i] for i in pick})


class NNProbe:
    """Within `with NNProbe() as p:`, records the validity masks and
    shapes of every ICP sweep the program makes (its ops/icp.icp_iteration
    calls, one nearest-neighbour search of B pairs each), holding
    references only; sweeps() reduces them once the traced work is done."""

    def __enter__(self):
        import lidar_slam_tpu_torch.ops.icp as icp_mod

        self._mod, self._orig = icp_mod, icp_mod.icp_iteration
        self.records = []
        orig, rec = self._orig, self.records

        def probe(src, tgt, src_mask, tgt_mask, *a, **k):
            rec.append((src_mask, tgt_mask, tuple(src.shape), tgt.shape[1]))
            return orig(src, tgt, src_mask, tgt_mask, *a, **k)

        icp_mod.icp_iteration = probe
        return self

    def __exit__(self, *exc):
        self._mod.icp_iteration = self._orig
        return False

    def sweeps(self) -> list[dict]:
        """Per sweep: pairs B, source points N, target points M, point
        width D, and the sum over pairs of valid sources x valid targets."""
        out = []
        for sm, tm, (B, N, D), M in self.records:
            vv = (sm.sum(-1).double() * tm.sum(-1).double()).sum()
            out.append({"B": B, "N": N, "M": M, "D": D, "valid_pairs":
                        float(vv)})
        return out
