"""The texture's two engines on chip_smoke.py [13]'s 2,407 frames, both on
the CPU: the record behind chip_smoke.py's TEX_ENGINE_CELLS_APART.

    python tests/torch_texture_engines.py [--frames 2407] [--threads 8]

The "device" engine's float32 chain (on the CPU; chip_smoke.py [13] holds
the card's bit for bit to it) and the "native" engine's float64 host
projector paint the frames on the 1201 x 1201 map at 0.05 m. The script
prints the cells painted and the cells whose texture differs, and checks,
frame by frame, JAX's documented measure-zero boundary case
(lidar_slam_tpu/models/texture.py:288-293): every pixel that the two
chains send to another cell, or colour from another source pixel, lies
within BOUNDARY_CELLS of a cell boundary (or of a registration row
boundary) in the float64 chain, and every cell whose texture differs was
touched by such a pixel. It exits 1 where a check fails. A few minutes:
too long for the test suite.

native_chain_pixels is a numpy transcription of the native projector
(csrc_host/slamhost.cpp slamio_project_frames) pixel by pixel, before its
last-writer dedupe; tests/test_torch_native.py holds it to the library.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

# a float32 world coordinate near 20 m is within 2e-6 m of the float64
# one: 4e-5 cells at 0.05 m; the registration row within a few 1e-5 rows
BOUNDARY_CELLS = 1e-4


def native_chain_pixels(disp: np.ndarray, pose, cam, map_cfg):
    """Per pixel of one frame, the native projector's (cell (H*W,) int64,
    -1 where invalid; source pixel (H*W,) int64 of its colour; grid
    coordinates before the ceil (gi, gj) and the registered row rgbi, each
    (H*W,) float64), with the library's arithmetic: depth from the
    disparity in float32, everything after in float64, reciprocal
    multiplies, the pose terms hoisted."""
    f = np.float32
    H, W = disp.shape
    depth_f = f(cam.depth_scale) / (f(cam.disp_a) * disp.astype(f)
                                    + f(cam.disp_b))
    regdd = (f(cam.reg_dd) * depth_f).astype(np.float64)
    depth = depth_f.astype(np.float64)
    ki00, ki02 = 1.0 / cam.fx, -cam.cx / cam.fx
    ki11, ki12 = 1.0 / cam.fy, -cam.cy / cam.fy
    pitch = cam.pitch_deg * 3.141592653589793 / 180.0
    cp, sp = math.cos(pitch), math.sin(pitch)
    j = np.arange(W, dtype=np.float64)
    i = np.arange(H, dtype=np.float64)[:, None]
    u = j * ki00 + ki02
    rgbj = (cam.reg_scale * j + cam.reg_j_off) / cam.reg_div
    colok = (rgbj >= 0) & (rgbj < W)
    vj = np.minimum(np.where(colok, rgbj, 0).astype(np.int64), W - 1)
    px, py, yaw = (float(v) for v in np.asarray(pose, np.float64))
    cyw, syw = math.cos(yaw), math.sin(yaw)
    Cx = cyw * cam.p_rc[0] - syw * cam.p_rc[1] + px
    Cy = syw * cam.p_rc[0] + cyw * cam.p_rc[1] + py
    rx = cp - sp * (i * ki11 + ki12)
    rgbi = (cam.reg_scale * i + cam.reg_i_off - regdd) * (1.0 / cam.reg_div)
    xw = depth * (cyw * rx + syw * u) + Cx
    yw = depth * (syw * rx + -cyw * u) + Cy
    inv_res = 1.0 / map_cfg.resolution
    gi = (xw - map_cfg.world_min_x) * inv_res
    gj = (yw - map_cfg.world_min_y) * inv_res
    ci, cj = np.ceil(gi) - 1, np.ceil(gj) - 1
    ok = (colok & (rgbi >= 0) & (rgbi < H) & (ci >= 0) & (ci < map_cfg.width)
          & (cj >= 0) & (cj < map_cfg.height))
    cell = np.where(ok, np.where(ok, ci, 0).astype(np.int64) * map_cfg.height
                    + np.where(ok, cj, 0).astype(np.int64), -1)
    src = np.where(ok, rgbi, 0).astype(np.int64) * W + vj
    return (cell.ravel(), src.ravel(), gi.ravel(), gj.ravel(),
            np.broadcast_to(rgbi, (H, W)).ravel())


def packed_colors(rgb: np.ndarray) -> np.ndarray:
    """(H*W,) int32 r | g << 8 | b << 16 of an (H, W, 3) uint8 frame."""
    c = rgb.reshape(-1, 3).astype(np.int32)
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16)


def boundary_distance(gi, gj, rgbi) -> np.ndarray:
    """Distance of each pixel's float64 grid coordinates and registered
    row to the nearest integer (a cell or row boundary)."""
    return np.minimum.reduce([np.abs(a - np.round(a)) for a in (gi, gj, rgbi)])


def engines_apart(disp, rgb, pose, cam, map_cfg):
    """(pixels (K,) where the two chains part on one frame, their
    distances to a boundary (K,), the cells those pixels reach in either
    chain)."""
    import torch

    from lidar_slam_tpu_torch.models import texture

    lin, col, _ = texture.frames_to_cells(
        torch.from_numpy(disp[None].view(np.int16)),
        torch.from_numpy(rgb[None]), torch.from_numpy(
            np.asarray(pose, np.float32)[None]), map_cfg, cam)
    lin, col = lin.numpy(), col.numpy()
    cell, src, gi, gj, rgbi = native_chain_pixels(disp, pose, cam, map_cfg)
    ncol = packed_colors(rgb)[src]
    px = np.nonzero((lin != cell) | ((cell >= 0) & (col != ncol)))[0]
    cells = np.concatenate([lin[px], cell[px]])
    return px, boundary_distance(gi[px], gj[px], rgbi[px]), cells[cells >= 0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from lidar_slam_tpu_torch.config import SlamConfig
    from lidar_slam_tpu_torch.models import texture

    torch.set_num_threads(args.threads)
    cfg = SlamConfig()
    poses, loader = chip_smoke.texture_frames()
    n = args.frames or chip_smoke.N_RGB_FRAMES
    grid = np.zeros((cfg.map.width, cfg.map.height), np.uint8)
    t0 = time.perf_counter()
    tex = {}
    for engine in ("device", "native"):
        tex[engine], got = texture.generate_texture_map(
            poses, np.arange(n), np.arange(n), grid, loader, cfg.map,
            cfg.camera, projector=engine, device="cpu")
        assert got == engine, got
    apart = np.nonzero((tex["device"] != tex["native"]).any(-1)
                       .reshape(-1).numpy())[0]
    painted = int((tex["device"] != 0).any(-1).sum())
    t1 = time.perf_counter()
    touched, n_px, worst = set(), 0, 0.0
    for s in range(0, n, 16):  # the loader's batches (its offset a batch)
        ids = np.arange(s, min(s + 16, n))
        disp, rgb = loader(ids)
        for k, f in enumerate(ids):
            px, dist, cells = engines_apart(disp[k], rgb[k], poses[f],
                                            cfg.camera, cfg.map)
            n_px += len(px)
            worst = max(worst, float(dist.max(initial=0.0)))
            touched.update(cells.tolist())
    untouched = sorted(set(apart.tolist()) - touched)
    print(f"{n} frames of 480 x 640 on {cfg.map.width} x {cfg.map.height} "
          f"cells: {painted} cells painted; texture cells apart between the "
          f"device and native engines: {len(apart)}; pixels apart: {n_px}, "
          f"the farthest {worst:.3e} cells or rows from a boundary (bound "
          f"{BOUNDARY_CELLS}); cells apart that no such pixel touched: "
          f"{len(untouched)} ({t1 - t0:.1f} s painting, "
          f"{time.perf_counter() - t1:.1f} s checking)")
    return 0 if worst <= BOUNDARY_CELLS and not untouched else 1


if __name__ == "__main__":
    sys.exit(main())
