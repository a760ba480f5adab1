"""Rank programs of the multi-rank layer's CPU tests.

Imported by name in every spawned rank (parallel/launch.run_ranks), so
this module imports torch and the port, never JAX. Each function takes its
rank's device and the numpy inputs the test made, builds the meshes, runs
every case and returns, on every rank, a dict of results (the launcher
hands rank 0's back); the single-device oracles run in the test process.
"""

from __future__ import annotations

import torch

from lidar_slam_tpu_torch.config import (CameraConfig, IcpConfig, MapConfig,
                                         PoseGraphConfig)
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
from lidar_slam_tpu_torch.parallel import sharding
from lidar_slam_tpu_torch.utils import tracing

T = torch.from_numpy


def _map(kw) -> MapConfig:
    return MapConfig(**kw)


def _mesh_case(m1, m2) -> dict:
    """Every rank's (dp, rp) coordinates on the 2-D mesh, gathered."""
    me = torch.tensor([m2.index("dp"), m2.index("rp"), m1.index("dp")],
                      dtype=torch.int32)
    block = mesh_lib.batch_sharding(torch.arange(8.0), m1)
    return {"shape_1d": m1.shape, "shape_2d": m2.shape,
            "backend": m1.backend,
            "coords": mesh_lib.all_gather(me, m1, "dp"),
            "blocks": mesh_lib.all_gather(block, m1, "dp"),
            "replicated": mesh_lib.replicated(torch.arange(3), m1)}


def _raises(fn) -> str:
    """The message of the ValueError fn raises ("" when it returns)."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


def parallel_cases(device: torch.device, inp: dict) -> dict:
    """Every case of tests/test_torch_parallel.py on this rank."""
    from lidar_slam_tpu_torch.models import particle_filter as pf
    from lidar_slam_tpu_torch.models import pf_slam
    from lidar_slam_tpu_torch.models import pose_graph as pg
    from lidar_slam_tpu_torch.models import relocalization as rl

    m1 = mesh_lib.make_mesh(4, ("dp",), device=device.type)
    m2 = mesh_lib.make_mesh(4, ("dp", "rp"), device=device.type)
    out = {"mesh": _mesh_case(m1, m2)}

    icp = inp["icp"]
    out["icp"] = sharding.sharded_icp_batch(m1)(
        *map(T, (icp["src"], icp["tgt"], icp["mask"], icp["mask"],
                 icp["T0"])), epsilon=1e-8, planar=True)

    maps = inp["maps"]
    cfg = _map(maps["cfg"])
    K = maps["K"]
    c = maps["rays"]
    for name, mesh, axis, init in (("rays", m1, "dp", None),
                                   ("rays_rp", m2, "rp", T(c["init"]))):
        build = sharding.sharded_build_logodds(mesh, cfg, K, axis=axis)
        out[f"map_{name}"] = build(T(c["poses"]), T(c["pts"]),
                                   T(c["masks"]), init=init)
    build = sharding.sharded_build_logodds_scans(m1, cfg, K)
    for name in ("scans", "saturating"):
        c = maps[name]
        init = None if c.get("init") is None else T(c["init"])
        out[f"map_{name}"] = build(T(c["poses"]), T(c["pts"]),
                                   T(c["masks"]), init=init)

    tex = inp["texture"]
    tcfg = _map(tex["cfg"])
    paint = sharding.sharded_texture_paint(m1, tcfg, CameraConfig())
    cells = tcfg.width * tcfg.height
    w = torch.full((cells,), -1, dtype=torch.int32)
    c = torch.zeros(cells, dtype=torch.int32)
    base, B, hw = 0, tex["disp"].shape[0], tex["disp"][0].size
    for s in range(0, B, 8):
        w, c = paint(w, c, T(tex["disp"][s:s + 8]), T(tex["rgb"][s:s + 8]),
                     T(tex["poses"][s:s + 8]), torch.ones(8, dtype=torch.bool),
                     base)
        base += 8 * hw
    # a padding batch paints nothing
    w, c = paint(w, c, T(tex["disp"][:8]), T(tex["rgb"][:8]),
                 T(tex["poses"][:8]), torch.zeros(8, dtype=torch.bool), base)
    out["texture"] = (w, c)
    paint_ops = sharding.sharded_paint_ops(m1, tcfg)
    w = torch.full((cells,), -1, dtype=torch.int32)
    c = torch.zeros(cells, dtype=torch.int32)
    base = 0
    for ops in tex["ops"]:
        w, c = paint_ops(w, c, T(ops), base)
        base += ops.shape[1]
    out["paint_ops"] = (w, c)
    out["paint_ops_uneven"] = _raises(lambda: paint_ops(
        w, c, T(tex["ops"][0][:, :-1]), 0))

    rel = inp["reloc"]
    rmap = _map(rel["cfg"])
    rcfg = rl.RelocConfig(**rel["reloc_cfg"])
    score = sharding.sharded_reloc_score(m1)
    im = T(rel["im"])
    out["reloc"] = rl.relocalize(im, rmap, T(rel["pts"]), T(rel["mask"]),
                                 rcfg, score_fn=score)
    out["reloc_jax_base"] = rl.search(
        im, rmap, tuple(map(T, rel["jax_base"])), rcfg, (0.0, 0.0),
        score_fn=score)

    p = inp["pf"]
    pmap = _map(p["cfg"])
    pf_score = sharding.sharded_pf_score(m1, pmap)
    out["pf_score"] = pf_score(T(p["particles"]), T(p["pts"][7]),
                               T(p["masks"][7]), T(p["im"]))
    pcfg = pf.PFConfig(n_particles=p["particles"].shape[0])
    noise = tuple(map(T, p["noise"]))
    out["pf_localize"] = pf.localize_particle_filter(
        T(p["im"]), T(p["counts"]), T(p["gyro"]), T(p["pts"]),
        T(p["masks"]), pmap, pcfg, x0=T(p["gt"][0]), score_fn=pf_score,
        noise=noise, device="cpu")
    out["pf_slam"] = pf_slam.slam_particle_filter(
        T(p["counts"]), T(p["gyro"]), T(p["pts"]), T(p["masks"]), pmap,
        pcfg, x0=T(p["gt"][0]), K=p["K"], score_fn=pf_score, noise=noise,
        device="cpu")

    g = inp["pose_graph"]
    for name, kw in g["cases"].items():
        li, lj, lmeas, lmask = (T(a) for a in kw["loops"])
        tracing.reset()
        tracing.enable()
        if name == "robust":
            cfg_pg = PoseGraphConfig(**kw["cfg"])
            res = sharding.sharded_optimize_trajectory(m1, cfg_pg)(
                T(kw["poses0"]), T(kw["rel"]), li, lj, lmeas, lmask)
        else:
            graph = pg.make_graph(T(kw["rel"]), loop_i=li, loop_j=lj,
                                  loop_meas=lmeas, loop_mask=lmask)
            res = pg.optimize_sharded(T(kw["poses0"]), graph, m1, band=10,
                                      max_iters=30, cost_rtol=1e-9)
        snap = tracing.snapshot()
        tracing.disable()
        out[f"pg_{name}"] = res
        out[f"pg_{name}_traced"] = (
            snap["counts"], [s.name for s in snap["spans"]])
    wide = g["wide"]
    li, lj, lmeas, lmask = (T(a) for a in wide["loops"])
    graph = pg.make_graph(T(wide["rel"]), loop_i=li, loop_j=lj,
                          loop_meas=lmeas, loop_mask=lmask)
    run = sharding.sharded_optimize_trajectory(
        m1, PoseGraphConfig(solver="banded", fixed_interval=10))
    out["pg_wide"] = (
        _raises(lambda: pg.optimize_sharded(T(wide["poses0"]), graph, m1,
                                            band=10)),
        _raises(lambda: run(T(wide["poses0"]), T(wide["rel"]), li, lj,
                            lmeas, lmask)))
    lmask_off = lmask.clone()
    lmask_off[0] = False
    out["pg_wide_gated_out"] = run(T(wide["poses0"]), T(wide["rel"]), li, lj,
                                   lmeas, lmask_off)
    out["collectives"] = (m1.calls + m2.calls, m1.bytes + m2.bytes)
    return out


def superstep_cases(device: torch.device, inp: dict) -> dict:
    """Every case of tests/test_torch_superstep.py on this rank: the fused
    step on the (2, 2) mesh, and its map backend refusing CPU tensors
    under "cuda"."""
    from lidar_slam_tpu_torch.parallel.superstep import make_slam_step

    mesh = mesh_lib.make_mesh(4, ("dp", "rp"), device=device.type)
    cfg = _map(inp["cfg"])
    out = {"mesh": mesh.shape}
    for name, c in inp["cases"].items():
        step = make_slam_step(mesh, cfg, inp["K"], IcpConfig(**c["icp"]),
                              PoseGraphConfig(**c["pg"]))
        out[name] = step(T(c["points"]), T(c["masks"]), T(c["odom"]),
                         T(c["logodds"]))
    c = inp["cases"]["window"]
    step = make_slam_step(mesh, cfg, inp["K"], IcpConfig(**c["icp"]),
                          PoseGraphConfig(**c["pg"]), map_backend="cuda")
    try:
        step(T(c["points"]), T(c["masks"]), T(c["odom"]), T(c["logodds"]))
        out["cuda_backend"] = ""
    except RuntimeError as err:
        out["cuda_backend"] = str(err)
    return out



def raise_on_rank(device: torch.device, bad: int) -> None:
    """Rank `bad` raises while the others wait for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise ValueError("optimize_sharded is banded-only (test)")
    dist.barrier()
