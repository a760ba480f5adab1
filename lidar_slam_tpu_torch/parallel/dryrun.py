"""The multi-rank dry run.

Counterpart of __graft_entry__.dryrun_multichip (the JAX package's entry
point): on an n-rank mesh ("dp", "rp"), shaped as the JAX package shapes
it ((n/2, 2)-like splits for even n >= 4, else (n, 1)), run one fused
SLAM step (parallel/superstep), the frame-sharded texture paint and the
op-stream paint over the port's own host projector (utils/native: built
here, or the run raises; the JAX entry skips that step where its library
is absent). Runs on the card unless given device="cpu":

    python -m lidar_slam_tpu_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .launch import run_ranks


def _rank(device: torch.device, n_devices: int) -> dict:
    from ..config import CameraConfig, IcpConfig, MapConfig, PoseGraphConfig
    from ..models import texture
    from ..models.occupancy import max_ray_cells
    from ..utils import native
    from .mesh import make_mesh
    from .sharding import sharded_paint_ops, sharded_texture_paint
    from .superstep import make_slam_step

    shape = None if n_devices >= 4 and n_devices % 2 == 0 else (n_devices, 1)
    mesh = make_mesh(n_devices, axes=("dp", "rp"), shape=shape,
                     device=device.type)
    rp, dp = mesh.size("rp"), mesh.size("dp")
    map_cfg = MapConfig(resolution=0.2, world_max_x=6, world_min_x=-6,
                        world_max_y=6, world_min_y=-6)
    K = max_ray_cells(map_cfg, 6.0)
    step = make_slam_step(mesh, map_cfg, K, IcpConfig(max_iters=64),
                          PoseGraphConfig(max_lm_iters=3, cg_iters=25))

    rng = np.random.default_rng(0)
    N, R = max(8, 2 * n_devices), 16 * rp
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, 5.0, (N, R))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=device)
    points = f32(np.stack([r * np.cos(ang), r * np.sin(ang),
                           np.zeros_like(r)], axis=-1))
    masks = torch.ones((N, R), dtype=torch.bool, device=device)
    odom = f32(np.cumsum(rng.normal(0, 0.02, (N, 3)), axis=0))
    logodds = torch.zeros((map_cfg.width, map_cfg.height), device=device)
    out = step(points, masks, odom, logodds)
    if out.poses.shape != (N, 3) or not bool(torch.isfinite(out.poses).all()):
        raise RuntimeError(f"superstep poses not finite {N} x 3")
    if not bool(torch.isfinite(out.logodds).all()):
        raise RuntimeError("superstep map not finite")

    # the frame-sharded paint: dp frames through the unproject chain
    cam = CameraConfig()
    B, H, W = dp, 24, 32
    disp = rng.integers(300, 900, (B, H, W)).astype(np.uint16)
    rgb = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    cells = map_cfg.width * map_cfg.height

    def carries():
        return (torch.full((cells,), -1, dtype=torch.int32, device=device),
                torch.zeros(cells, dtype=torch.int32, device=device))

    disp_t = torch.as_tensor(disp.astype(np.float32), device=device)
    rgb_t = torch.as_tensor(rgb, device=device)
    winner, color = sharded_texture_paint(mesh, map_cfg, cam)(
        *carries(), disp_t, rgb_t, out.poses[:B],
        torch.ones(B, dtype=torch.bool, device=device), 0)
    lin, cols, _ = texture.frames_to_cells(disp_t, rgb_t, out.poses[:B],
                                           map_cfg, cam)
    w1, c1 = texture.paint_cells(*carries(), lin, cols, 0)
    if not (torch.equal(winner, w1) and torch.equal(color, c1)):
        raise RuntimeError("the frame-sharded paint differs from paint_cells")

    # the op-stream paint over the host projector's ops
    op_cells, op_colors = native.project_frames(
        disp, rgb, out.poses[:B].cpu().numpy().astype(np.float64), cam,
        map_cfg)
    ops = torch.as_tensor(texture._pad_paint_ops(op_cells, op_colors,
                                                 min_pad=8 * dp),
                          device=device)
    w_ops, c_ops = sharded_paint_ops(mesh, map_cfg)(*carries(), ops, 0)
    w2, c2 = texture.paint_ops(*carries(), ops, 0)
    if not (torch.equal(w_ops, w2) and torch.equal(c_ops, c2)):
        raise RuntimeError("the op-stream paint differs from paint_ops")

    summary = {
        "devices": n_devices, "mesh": dict(mesh.shape),
        "backend": mesh.backend, "device": str(device),
        "poses": tuple(out.poses.shape), "map": tuple(out.logodds.shape),
        "graph_cost": float(out.graph_cost),
        "cells_painted": int((winner >= 0).sum()),
        "op_cells_painted": int((w_ops >= 0).sum()),
        "collectives": mesh.calls, "collective_bytes": mesh.bytes,
        "collective_s": mesh.seconds}
    return summary


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run on n_devices ranks (parallel/launch.run_ranks; on
    the card, ranks share it when there are fewer cards than ranks), print
    its summary and return it."""
    s = run_ranks(_rank, n_devices, None, device, n_devices)
    print(f"dryrun_multichip OK on {s['devices']} ranks (mesh {s['mesh']}, "
          f"{s['backend']} on {s['device']}): poses {s['poses']}, map "
          f"{s['map']}, graph cost {s['graph_cost']:.4f}; texture cells "
          f"painted {s['cells_painted']} (frame-sharded, equal to "
          f"paint_cells) and {s['op_cells_painted']} (op-stream, equal to "
          f"paint_ops); rank 0: {s['collectives']} collectives, "
          f"{s['collective_bytes']} bytes, {s['collective_s']:.3f} s",
          flush=True)
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
