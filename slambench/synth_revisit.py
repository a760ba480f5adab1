"""The seeded revisit logs of the revisit deployment (main.py --mode gtsam
--loop_proposer descriptor --robust_loss huber): a frozen copy of the
port's revisit generator (lidar_slam_tpu_torch/utils/io.py,
synthetic_revisit_dataset), so that later changes to the program cannot
change the yardstick's inputs.

The robot drives a circle `laps` times in synth.py's room (walls 8 m
beyond the drive, 12 pillars), so every pose of lap k revisits the pose
of lap k - 1 at the same index modulo the lap; the gyro reads
`gyro_scale` of the true yaw rate, so every estimate drifts. The schema
and the noise are synth.synthetic_dataset's: 0.05 encoder ticks, 2e-3
rad/s gyro, 3 mm range, 2% dropouts past range_max. The trajectory, the
room and its pillars do not depend on the seed; the seed draws the noise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from synth import _raycast_room


def synthetic_revisit_dataset(
    n_steps: int = 360,
    n_rays: int = 541,
    gyro_scale: float = 0.97,
    radius: float = 3.0,
    seed: int = 7,
    range_min: float = 0.1,
    range_max: float = 30.0,
    laps: int = 1,
) -> Dict:
    """A circle of `radius` driven `laps` times in n_steps steps at 40 Hz,
    ground truth from the origin heading along +x; the log's arrays as
    synth.synthetic_dataset returns them."""
    rng = np.random.default_rng(seed)
    freq = 40.0
    dt = 1.0 / freq
    t0 = 1e9
    stamps = t0 + np.arange(n_steps) * dt
    w_true = 2 * np.pi * laps / (n_steps * dt)    # `laps` full turns
    v_true = w_true * radius
    t = np.arange(n_steps) * dt
    theta = w_true * t
    gt_poses = np.stack([radius * np.sin(theta),
                         radius * (1 - np.cos(theta)), theta], axis=1)

    ticks = np.full(n_steps, v_true / (0.0022 * freq))
    counts = np.stack([ticks] * 4, axis=1) + rng.normal(0, 0.05, (n_steps, 4))
    gyro = np.zeros((n_steps, 3))
    gyro[:, 2] = w_true * gyro_scale + rng.normal(0, 2e-3, n_steps)
    acc = np.zeros((n_steps, 3))
    acc[:, 2] = 9.81

    angles = np.linspace(np.radians(-135.0), np.radians(135.0), n_rays)
    ranges = _raycast_room(gt_poses, angles, range_max, rng)
    ranges = np.clip(ranges + rng.normal(0, 0.003, ranges.shape), 0.0,
                     range_max + 5.0)
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
        "rgbd": {"disp_stamps": stamps[:10], "rgb_stamps": stamps[:10]},
        "ground_truth": gt_poses,
    }
