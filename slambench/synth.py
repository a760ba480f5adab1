"""The seeded synthetic logs every cell runs on: a frozen copy of the
port's dataset generator (lidar_slam_tpu_torch/utils/io.py), so that later
changes to the program cannot change the yardstick's inputs.

A log has the shapes of the UCSD ECE 276A PR2 datasets: one synchronized
step per encoder sample at 40 Hz, each with 4 encoder counts, a gyro and a
Hokuyo scan of n_rays beams over 270 degrees. The trajectory, the room and
its pillars do not depend on the seed; the seed draws the encoder, gyro
and range noise and the ~2% dropouts, so every seed gives the same work.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_dataset(
    n_steps: int = 4956,
    n_rays: int = 1081,
    n_rgb: int = 200,
    seed: int = 0,
    range_min: float = 0.1,
    range_max: float = 30.0,
    speed: float = 0.30,
    speed_amp: float = 0.12,
    yaw_amp: float = 0.25,
) -> Dict:
    """Generate a dataset-20-shaped synthetic dataset.

    A robot drives a loopy trajectory inside a rectangular room with a few
    pillars; lidar ranges are raycast analytically against the walls. Shapes
    mirror the reference loader output (reference: modules/utils.py:77-100;
    dataset-20 sizes from outputs/poses_odom_20.npy = (4956, 3)).
    """
    rng = np.random.default_rng(seed)
    freq = 40.0
    dt = 1.0 / freq
    t0 = 1e9
    stamps = t0 + np.arange(n_steps) * dt

    # Smooth velocity/yaw-rate profile -> ground-truth trajectory.
    t = np.arange(n_steps) * dt
    v = speed + speed_amp * np.sin(2 * np.pi * t / 40.0)
    w = yaw_amp * np.sin(2 * np.pi * t / 25.0) + 0.06 * np.sin(2 * np.pi * t / 7.0)
    theta = np.cumsum(w * dt)
    x = np.cumsum(v * dt * np.cos(theta))
    y = np.cumsum(v * dt * np.sin(theta))
    gt_poses = np.stack([x, y, theta], axis=1)

    # Encoder counts consistent with v: counts such that
    # v = ((FR+RR)/2 + (FL+RL)/2)/2 * 0.0022 * 40  (reference: localization.py:146-158)
    ticks = v / (0.0022 * freq)
    counts = np.stack([ticks, ticks, ticks, ticks], axis=1)
    counts += rng.normal(0, 0.05, counts.shape)

    # IMU gyro: z is yaw rate.
    gyro = np.zeros((n_steps, 3))
    gyro[:, 2] = w + rng.normal(0, 2e-3, n_steps)
    acc = np.zeros((n_steps, 3))
    acc[:, 2] = 9.81

    # Lidar: analytic raycast against an axis-aligned room and pillars.
    angles = np.linspace(np.radians(-135.0), np.radians(135.0), n_rays)
    ranges = _raycast_room(gt_poses, angles, range_max, rng)
    # ~3 mm range noise, typical of the Hokuyo class of scanner
    ranges = np.clip(ranges + rng.normal(0, 0.003, ranges.shape), 0.0, range_max + 5.0)

    rgb_stamps = t0 + np.linspace(0, n_steps * dt, n_rgb)
    disp_stamps = t0 + np.linspace(0, n_steps * dt, int(n_rgb * 1.2))

    return {
        "encoder": {"counts": counts, "stamps": stamps},
        "lidar": {
            "angle_min": np.radians(-135.0),
            "angle_max": np.radians(135.0),
            "angle_increment": np.radians(270.0) / (n_rays - 1),
            "range_min": np.float64(range_min),
            "range_max": np.float64(range_max),
            "ranges": ranges,
            "stamps": stamps + rng.normal(0, 1e-4, n_steps),
        },
        "imu": {
            "angular_velocity": gyro,
            "linear_acceleration": acc,
            "stamps": stamps + rng.normal(0, 1e-4, n_steps),
        },
        "rgbd": {"disp_stamps": disp_stamps, "rgb_stamps": rgb_stamps},
        "ground_truth": gt_poses,
    }


def _raycast_room(poses: np.ndarray, angles: np.ndarray, range_max: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Analytic ray distances against a rectangular room plus circular
    pillars (pillars give ICP rotational/translational constraints that bare
    walls lack), with ~2% random dropouts (returned beyond range_max) so the
    validity-mask paths see real traffic."""
    margin = 8.0
    xmin, xmax = poses[:, 0].min() - margin, poses[:, 0].max() + margin
    ymin, ymax = poses[:, 1].min() - margin, poses[:, 1].max() + margin

    th = poses[:, 2:3] + angles[None, :]  # (N, R) world-frame ray angles
    c, s = np.cos(th), np.sin(th)
    # rays originate at the SENSOR, which sits p_rl forward of the body
    # frame (LidarConfig.p_rl = 0.13323 m; ops/scan.py adds that offset
    # back when converting ranges to body-frame points). Casting from the
    # body origin instead is invisible to same-heading scan pairs but
    # biases any opposite-heading alignment by exactly 2|p_rl| = 0.266 m
    # (found by the reversed-lap closure probe: GT-seeded trimmed ICP
    # landed 0.263-0.268 m off with 0.05-degree yaw error).
    lidar_off = 0.13323
    px = poses[:, 0:1] + lidar_off * np.cos(poses[:, 2:3])
    py = poses[:, 1:2] + lidar_off * np.sin(poses[:, 2:3])

    with np.errstate(divide="ignore", invalid="ignore"):
        tx = np.where(c > 0, (xmax - px) / c, np.where(c < 0, (xmin - px) / c, np.inf))
        ty = np.where(s > 0, (ymax - py) / s, np.where(s < 0, (ymin - py) / s, np.inf))
    r = np.minimum(tx, ty).astype(np.float32)

    # circular pillars scattered through the room interior
    n_pillars = 12
    prng = np.random.default_rng(12345)
    cx = prng.uniform(xmin + 1, xmax - 1, n_pillars)
    cy = prng.uniform(ymin + 1, ymax - 1, n_pillars)
    rad = prng.uniform(0.2, 0.6, n_pillars)
    for k in range(n_pillars):
        ox = (cx[k] - px).astype(np.float32)  # (N, 1)
        oy = (cy[k] - py).astype(np.float32)
        t_close = ox * c + oy * s  # (N, R)
        d2 = ox * ox + oy * oy - t_close * t_close
        hit = (d2 < rad[k] ** 2) & (t_close > 0)
        with np.errstate(invalid="ignore"):
            t_hit = t_close - np.sqrt(np.maximum(rad[k] ** 2 - d2, 0.0))
        r = np.where(hit & (t_hit < r), t_hit, r)

    # dropouts: ~2% of rays return past range_max (invalid)
    drop = rng.random(r.shape) < 0.02
    return np.where(drop, range_max * 1.5, np.minimum(r, range_max * 1.2))
