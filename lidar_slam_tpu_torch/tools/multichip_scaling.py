"""Multi-rank scaling of the sharded map builders on the card.

Counterpart of tools/multichip_scaling.py. Times sharded_build_logodds
(rays split, one psum of the (W, H) delta a scan) and
sharded_build_logodds_scans (scans split, clamp-affine composition, one
gather of 3 grids) on 1, 2 and 4 ranks (parallel/launch.run_ranks), each
against raywalk_build (K1) on the same rays within 1e-4.

Caveat on reading it: on one card the ranks time-share the GPU and gloo
stages every collective through host memory, so the wall time measures
the sharding's overhead, not a speed-up. What carries over to a card a
rank is printed on every row: each rank's work (scans walked; ray slots a
scan) and the bytes a rank's collectives move.

    python -m lidar_slam_tpu_torch.tools.multichip_scaling [n_steps]
        [--ranks 1 2 4]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import card, require_cuda

N_RAYS = 1080  # divisible by 1, 2, 4 and 8, as the JAX tool's


def world(inp: dict, device) -> tuple:
    """The JAX tool's random log on `device`: poses (N, 3), points
    (N, R, 2) up to 20 m over +/-2.36 rad, masks (N, R)."""
    rng = np.random.default_rng(inp["seed"])
    n, r = inp["n_steps"], inp["n_rays"]
    ang = rng.uniform(-2.36, 2.36, (n, r))
    rr = rng.uniform(0.3, 20.0, (n, r))
    pts = np.stack([rr * np.cos(ang), rr * np.sin(ang)], -1)
    masks = rng.random((n, r)) > 0.02
    poses = np.cumsum(rng.normal(0, 0.02, (n, 3)), 0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=device)
    return f32(poses), f32(pts), torch.as_tensor(masks, device=device)


def rank_program(device: torch.device, inp: dict) -> dict:
    """One rank's run: both builders warmed up once, then timed (host
    clock to a synchronize) with the mesh's collective counters reset
    just before; rank 0's rows come back."""
    from ..config import MapConfig
    from ..kernels.raywalk import raywalk_build
    from ..models import occupancy
    from ..parallel import sharding
    from ..parallel.mesh import make_mesh

    cfg = MapConfig(**inp["map"])
    mesh = make_mesh(device=device.type)
    D = mesh.size("dp")
    poses, pts, masks = world(inp, device)
    K = occupancy.adaptive_ray_cells(pts, masks, cfg, 30.0)
    ref = raywalk_build(occupancy.ray_ends(poses, pts, cfg), masks, cfg, K)
    n = poses.shape[0]
    padded = {  # scans padded with all-masked ones
        "scans": tuple(sharding.pad_batch(a, D, pad_value=v)[0]
                       for a, v in ((poses, 0), (pts, 0), (masks, False)))}
    padded["rays"] = (poses, sharding.pad_batch(pts, D, axis=1)[0],
                      sharding.pad_batch(masks, D, axis=1,
                                         pad_value=False)[0])
    rows = {}
    for split, make in (("rays", sharding.sharded_build_logodds),
                        ("scans", sharding.sharded_build_logodds_scans)):
        build = make(mesh, cfg, K)
        build(*padded[split])  # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mesh.reset_counters()
        t0 = time.perf_counter()
        grid = build(*padded[split])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        r = padded[split][1].shape[1]
        rows[split] = dict(
            wall_s=wall, collective_s=mesh.seconds, collectives=mesh.calls,
            collective_bytes=mesh.bytes,
            scans_walked=(n if split == "rays" else
                          padded["scans"][0].shape[0] // D),
            slots_a_scan=(r // D if split == "rays" else r) * K,
            max_abs_diff=float((grid - ref).abs().max()))
    return dict(K=K, backend=mesh.backend, rows=rows)


def run(n_steps: int = 256, ranks=(1, 2, 4), device="cuda",
        map_kw: dict | None = None, log=print) -> dict:
    """Both builders on each rank count; returns {ranks: rank 0's rows}."""
    from ..parallel.launch import run_ranks

    inp = dict(n_steps=n_steps, n_rays=N_RAYS, seed=0, map=map_kw or {})
    out = {}
    for d in ranks:
        res = run_ranks(rank_program, d, None, device, inp)
        out[d] = res
        for split, row in res["rows"].items():
            log(f"{split}-sharded, {d} rank(s) on {device} "
                f"({res['backend']}): "
                f"{row['wall_s']:.3f} s wall, collectives "
                f"{row['collectives']} x, {row['collective_bytes']:,} bytes, "
                f"{row['collective_s']:.3f} s a rank | a rank walks "
                f"{row['scans_walked']} of {n_steps} scans at "
                f"{row['slots_a_scan']:,} slots a scan (K = {res['K']}) | "
                f"max |diff| against raywalk_build {row['max_abs_diff']:.2e}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", type=int, nargs="?", default=256)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args(argv)
    require_cuda("multichip_scaling")
    print(card(), flush=True)
    rows = run(args.n_steps, tuple(args.ranks))
    bad = [(d, s) for d, r in rows.items() for s, row in r["rows"].items()
           if row["max_abs_diff"] > 1e-4]
    if bad:
        raise SystemExit(f"sharded maps off raywalk_build: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
