"""Interop exports: ROS map_server (PGM + YAML) and TUM trajectories.

numpy copy of lidar_slam_tpu/utils/export.py (which the port cannot import
without JAX); the files it writes are byte-identical to the original's.

The reference persists only matplotlib PNGs and raw `.npy` arrays
(reference: modules/ogm.py:66-85, modules/utils.py:5-34). Downstream
consumers of a SLAM system usually want standard formats instead: ROS's
`map_server` occupancy map (a binary P5 PGM plus a YAML with resolution
and origin — consumable by nav2/AMCL), and TUM-format trajectories
(`timestamp x y z qx qy qz qw`, the format the evo/TUM-RGBD tooling
evaluates ATE/RPE on). Both are first-party here: plain-text/PGM writers
with no new dependencies, round-trip readers for testing.

Conventions:
- Our grid is (width, height) indexed [i, j] with i along world x and
  j along world y; cell (0, 0)'s lower corner is (world_min_x,
  world_min_y) (models/occupancy.py world2grid, reference
  modules/ogm.py:102-124). A PGM image is row-major with row 0 at the
  TOP, and map_server places the YAML `origin` at the LOWER-LEFT pixel,
  so image[row, col] = grid[col, height-1-row].
- Occupancy probability is sigmoid(+logodds) (the +log4 hits are
  occupied; NB the reference's own `pmf` is sigmoid(-logodds), a
  free-space probability — modules/ogm.py:61-64). map_server with
  negate=0 reads occ = (255 - pixel)/255, so occupied -> pixel 0,
  free -> pixel 254, never-observed (logodds == 0) -> pixel 205
  (the conventional unknown gray).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

from ..config import MapConfig

# map_server defaults (nav2 map_io defaults)
OCCUPIED_THRESH = 0.65
FREE_THRESH = 0.196
_PIX_OCCUPIED = 0
_PIX_FREE = 254
_PIX_UNKNOWN = 205


def map_to_ros_image(logodds: np.ndarray) -> np.ndarray:
    """Log-odds grid (W, H) -> map_server uint8 image (H, W), row 0 at top.

    Trinary thresholding at the map_server's own occ/free thresholds on
    p_occ = sigmoid(logodds); exactly-zero log-odds (never observed) are
    unknown regardless of thresholds.
    """
    lo = np.asarray(logodds, dtype=np.float64)
    p_occ = 1.0 / (1.0 + np.exp(-lo))
    img = np.full(lo.shape, _PIX_UNKNOWN, dtype=np.uint8)
    img[p_occ > OCCUPIED_THRESH] = _PIX_OCCUPIED
    img[(p_occ < FREE_THRESH) & (lo != 0.0)] = _PIX_FREE
    # grid[i, j] (x, y) -> image[height-1-j, i]
    return img.T[::-1].copy()


def save_map_ros(logodds: np.ndarray, cfg: MapConfig, stem: str) -> Tuple[str, str]:
    """Write `<stem>.pgm` + `<stem>.yaml` in ROS map_server format.

    Returns (pgm_path, yaml_path). The YAML `origin` is the world pose of
    the lower-left pixel: cell (0, 0)'s lower corner, i.e.
    (world_min_x, world_min_y, 0).
    """
    img = map_to_ros_image(logodds)
    pgm_path = stem + ".pgm"
    yaml_path = stem + ".yaml"
    h, w = img.shape
    with open(pgm_path, "wb") as f:
        f.write(b"P5\n# lidar_slam_tpu occupancy map\n")
        f.write(f"{w} {h}\n255\n".encode())
        f.write(img.tobytes())
    with open(yaml_path, "w") as f:
        f.write(f"image: {os.path.basename(pgm_path)}\n")
        f.write(f"resolution: {cfg.resolution}\n")
        f.write(f"origin: [{cfg.world_min_x}, {cfg.world_min_y}, 0.0]\n")
        f.write("negate: 0\n")
        f.write(f"occupied_thresh: {OCCUPIED_THRESH}\n")
        f.write(f"free_thresh: {FREE_THRESH}\n")
    return pgm_path, yaml_path


def load_map_ros(yaml_path: str) -> Tuple[np.ndarray, dict]:
    """Read a map_server YAML + PGM pair back.

    Returns (image (H, W) uint8 with row 0 at top, metadata dict with
    resolution/origin/negate/thresholds). Round-trip/test utility; also
    reads third-party map_server maps (binary P5 only).
    """
    meta: dict = {}
    with open(yaml_path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, val = line.split(":", 1)
            val = val.strip()
            if val.startswith("["):
                meta[key.strip()] = [float(v) for v in
                                     val.strip("[]").split(",")]
            else:
                try:
                    meta[key.strip()] = float(val)
                except ValueError:
                    meta[key.strip()] = val
    pgm_path = os.path.join(os.path.dirname(yaml_path), str(meta["image"]))
    with open(pgm_path, "rb") as f:
        data = f.read()
    # P5 header: magic, (comments), width height, maxval, single whitespace
    tokens = []
    pos = 2  # skip "P5"
    while len(tokens) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    pos += 1  # the single whitespace after maxval
    w, h, _maxval = tokens
    img = np.frombuffer(data[pos:pos + w * h], dtype=np.uint8).reshape(h, w)
    return img, meta


def ros_image_to_grid(img: np.ndarray) -> np.ndarray:
    """Invert map_to_ros_image's transpose/flip: image (H, W) -> (W, H)."""
    return img[::-1].T.copy()


def yaw_to_quaternion(yaw: np.ndarray) -> np.ndarray:
    """SE(2) yaw -> (..., 4) quaternion [qx, qy, qz, qw] about +z."""
    yaw = np.asarray(yaw, dtype=np.float64)
    half = yaw / 2.0
    q = np.zeros(yaw.shape + (4,), dtype=np.float64)
    q[..., 2] = np.sin(half)
    q[..., 3] = np.cos(half)
    return q


def save_trajectory_tum(path: str, poses: np.ndarray,
                        stamps: Optional[np.ndarray] = None) -> str:
    """Write (N, 3) SE(2) poses [x, y, yaw] as a TUM trajectory file.

    Format: `timestamp x y z qx qy qz qw` per line (the evo / TUM-RGBD
    benchmark format). stamps defaults to the pose index; z is 0.
    """
    poses = np.asarray(poses, dtype=np.float64)
    if stamps is None:
        stamps = np.arange(poses.shape[0], dtype=np.float64)
    stamps = np.asarray(stamps, dtype=np.float64)
    q = yaw_to_quaternion(poses[:, 2])
    with open(path, "w") as f:
        f.write("# timestamp x y z qx qy qz qw\n")
        for t, p, qi in zip(stamps, poses, q):
            f.write(f"{t:.6f} {p[0]:.9f} {p[1]:.9f} 0.000000000 "
                    f"{qi[0]:.9f} {qi[1]:.9f} {qi[2]:.9f} {qi[3]:.9f}\n")
    return path


def load_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file -> (stamps (N,), poses (N, 3) [x, y, yaw]).

    yaw is recovered from the quaternion's z-rotation component (atan2 of
    the full rotation's first column, so tilted quaternions still project
    sensibly onto SE(2)).
    """
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            t, x, y, _z, qx, qy, qz, qw = vals[:8]
            # rotation's first column: R00 = 1-2(qy^2+qz^2), R10 = 2(qx qy + qz qw)
            yaw = math.atan2(2.0 * (qx * qy + qz * qw),
                             1.0 - 2.0 * (qy * qy + qz * qz))
            stamps.append(t)
            poses.append((x, y, yaw))
    return (np.asarray(stamps, dtype=np.float64),
            np.asarray(poses, dtype=np.float64))
