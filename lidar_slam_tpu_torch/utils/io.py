"""Host-side IO for the port: npy persistence, dataset loading, synthetic data.

numpy copies of the JAX package's loaders (lidar_slam_tpu/utils/io.py),
which cannot be imported without JAX. The synthetic generator is seeded
exactly like the original, so the same seed gives the same arrays
(tests/test_torch_port_imports.py holds them equal).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

DATASET_NAMES = {
    "encoder": "Encoders",
    "lidar": "Hokuyo",
    "imu": "Imu",
    "rgbd": "Kinect",
}


def save_numpy(array, filename: str) -> None:
    """Save an array, appending .npy when absent (reference: modules/utils.py:5-19)."""
    if not filename.endswith(".npy"):
        filename += ".npy"
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "wb") as f:
        np.save(f, np.asarray(array))


def load_numpy(filename: str) -> np.ndarray:
    """Load an array, appending .npy when absent (reference: modules/utils.py:21-34)."""
    if not filename.endswith(".npy"):
        filename += ".npy"
    with open(filename, "rb") as f:
        return np.load(f)


def load_data(dataset_num: int, dataset_names: Dict[str, str] | None = None,
              data_folder: str = "data/") -> Dict:
    """Load the 4 sensor npz files for one dataset into a nested dict,
    transposed time-major (reference: modules/utils.py:36-102)."""
    dataset_names = dataset_names or DATASET_NAMES
    if not os.path.exists(data_folder):
        raise ValueError("Data folder does not exist.")
    if not data_folder.endswith("/"):
        data_folder += "/"
    if dataset_num not in [20, 21]:
        raise ValueError("Invalid dataset number. Must be 20 or 21.")

    with np.load(f"{data_folder}{dataset_names['encoder']}{dataset_num}.npz") as d:
        encoder = {"counts": d["counts"].T, "stamps": d["time_stamps"]}
    with np.load(f"{data_folder}{dataset_names['lidar']}{dataset_num}.npz") as d:
        lidar = {
            "angle_min": d["angle_min"],
            "angle_max": d["angle_max"],
            "angle_increment": d["angle_increment"].item(),
            "range_min": d["range_min"],
            "range_max": d["range_max"],
            "ranges": d["ranges"].T,
            "stamps": d["time_stamps"],
        }
    with np.load(f"{data_folder}{dataset_names['imu']}{dataset_num}.npz") as d:
        imu = {
            "angular_velocity": d["angular_velocity"].T,
            "linear_acceleration": d["linear_acceleration"].T,
            "stamps": d["time_stamps"],
        }
    with np.load(f"{data_folder}{dataset_names['rgbd']}{dataset_num}.npz") as d:
        rgbd = {"disp_stamps": d["disparity_time_stamps"], "rgb_stamps": d["rgb_time_stamps"]}

    return {"encoder": encoder, "lidar": lidar, "imu": imu, "rgbd": rgbd}


def find_nearest_indices(array: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Vectorized nearest-value index lookup.

    Replaces the O(N*M) Python scan (reference: modules/utils.py:104-138) with
    an O((N+M) log N) searchsorted; tie-breaking matches argmin-of-abs-diff
    (first/lower index wins on exact ties).
    """
    array = np.asarray(array, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(array, kind="stable")
    sorted_arr = array[order]
    pos = np.searchsorted(sorted_arr, values)
    pos = np.clip(pos, 1, len(sorted_arr) - 1)
    left = sorted_arr[pos - 1]
    right = sorted_arr[pos]
    # argmin returns the FIRST minimal index; with a sorted unique array the
    # lower neighbor wins ties (|v-left| == |v-right| -> left).
    take_left = (values - left) <= (right - values)
    idx_sorted = np.where(take_left, pos - 1, pos)
    return order[idx_sorted]


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


def synthetic_dataset_21(
    n_steps: int = 4905,
    n_rays: int = 1081,
    n_rgb: int = 160,
    seed: int = 21,
    range_min: float = 0.1,
    range_max: float = 60.0,
) -> Dict:
    """Dataset-21-shaped synthetic dataset: the same schema with different
    shapes and extents from dataset 20 (another step count, a faster and
    wider trajectory, a doubled range_max), so the adaptive per-ray cell
    budget and the CLI grid sizing must adapt."""
    return synthetic_dataset(
        n_steps=n_steps, n_rays=n_rays, n_rgb=n_rgb, seed=seed,
        range_min=range_min, range_max=range_max,
        speed=0.85, speed_amp=0.25, yaw_amp=0.12)


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
    """A revisit scene for loop-closure work: a circle of `radius` driven
    `laps` times around the raycast room, so the trajectory revisits its
    own earlier poses — while `gyro_scale` biases the measured yaw rate so
    every pose estimate DRIFTS (~2.8 m by loop end at the defaults).
    laps=1 revisits only the start; laps>=2 makes EVERY pose of lap k a
    revisit of lap k-1 (pairs (i, i + n_steps/laps)) — the multi-site case.

    Same schema as synthetic_dataset. This is the calibration scene for
    the revisit proposers and the ICP-error verification gate
    (models/slam.py); the plain synthetic_dataset trajectory wanders
    without ever revisiting, so it cannot exercise loop closure beyond
    fixed-interval pairs.
    """
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


def synthetic_reverse_lap_dataset(
    n_lap: int = 360,
    n_rays: int = 541,
    gyro_scale: float = 0.98,
    turn_steps: int = 20,
    radius: float = 3.0,
    seed: int = 7,
    range_min: float = 0.1,
    range_max: float = 30.0,
) -> Dict:
    """Drive a circle CCW, turn 180 degrees, retrace it CW: every lap-2
    pose revisits a lap-1 pose with ~180-degree HEADING DIFFERENCE —
    the any-heading revisit benchmark. Appearance descriptors cannot
    propose these (the 270-degree FOV windows barely overlap), but
    metric proximity + prior-seeded TRIMMED ICP verification
    (PoseGraphConfig.proximity_seed="estimate", proximity_trim~0.55)
    measures them to ~mm and the closures restore cross-lap map
    consistency. gyro_scale biases the measured yaw rate (drift). Same
    schema as synthetic_dataset; total steps = 2*n_lap + turn_steps.
    """
    rng = np.random.default_rng(seed)
    freq = 40.0
    dt = 1.0 / freq
    t0 = 1e9
    n = 2 * n_lap + turn_steps
    stamps = t0 + np.arange(n) * dt
    w0 = 2 * np.pi / (n_lap * dt)
    v = np.full(n, w0 * radius)
    w = np.zeros(n)
    w[:n_lap] = w0
    w[n_lap:n_lap + turn_steps] = np.pi / (turn_steps * dt)
    w[n_lap + turn_steps:] = -w0
    theta = np.cumsum(w * dt)
    gt_poses = np.stack([np.cumsum(v * dt * np.cos(theta)),
                         np.cumsum(v * dt * np.sin(theta)), theta], axis=1)

    counts = np.stack([v / (0.0022 * freq)] * 4, axis=1)
    counts += rng.normal(0, 0.05, counts.shape)
    gyro = np.zeros((n, 3))
    gyro[:, 2] = w * gyro_scale + rng.normal(0, 2e-3, n)
    acc = np.zeros((n, 3))
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
            "stamps": stamps + rng.normal(0, 1e-4, n),
        },
        "imu": {
            "angular_velocity": gyro,
            "linear_acceleration": acc,
            "stamps": stamps + rng.normal(0, 1e-4, n),
        },
        "rgbd": {"disp_stamps": stamps[:10], "rgb_stamps": stamps[:10]},
        "ground_truth": gt_poses,
    }


def synthetic_outback_dataset(
    n_steps: int = 400,
    n_rays: int = 541,
    gyro_scale: float = 0.99,
    turn_steps: int = 40,
    speed: float = 0.8,
    seed: int = 3,
    range_min: float = 0.1,
    range_max: float = 30.0,
) -> Dict:
    """A there-and-back scene: straight out, one 180-degree turn, straight
    back along (nearly) the same line — so every inbound pose revisits an
    outbound pose at ~0.5 m lateral offset (the turn diameter) and
    ~180-degree HEADING DIFFERENCE. This is the opposite-heading revisit
    case: appearance descriptors fail here (the 270-degree FOV windows
    barely overlap), but metric proximity proposals + prior-seeded
    TRIMMED ICP verification close it.
    gyro_scale biases the measured yaw rate (drift). Same schema as
    synthetic_dataset.
    """
    rng = np.random.default_rng(seed)
    freq = 40.0
    dt = 1.0 / freq
    t0 = 1e9
    stamps = t0 + np.arange(n_steps) * dt
    out = (n_steps - turn_steps) // 2
    v = np.full(n_steps, speed)
    w = np.zeros(n_steps)
    w[out:out + turn_steps] = np.pi / (turn_steps * dt)
    theta = np.cumsum(w * dt)
    gt_poses = np.stack([np.cumsum(v * dt * np.cos(theta)),
                         np.cumsum(v * dt * np.sin(theta)), theta], axis=1)

    ticks = v / (0.0022 * freq)
    counts = np.stack([ticks] * 4, axis=1) + rng.normal(0, 0.05,
                                                        (n_steps, 4))
    gyro = np.zeros((n_steps, 3))
    gyro[:, 2] = w * gyro_scale + rng.normal(0, 2e-3, n_steps)
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


def _se2_T(pose: np.ndarray) -> np.ndarray:
    c, s = np.cos(pose[2]), np.sin(pose[2])
    return np.array([[c, -s, pose[0]], [s, c, pose[1]], [0, 0, 1]])


def kidnap_log(n: int = 400, t_kidnap: int = 300, t_target: int = 70,
               n_rays: int = 541, seed: int = 0):
    """The kidnapped-robot log of the JAX package's online tests
    (tests/test_online.py::_kidnap_log): a steady arc whose robot is
    teleported at step t_kidnap back to its step-t_target pose, while the
    encoders and gyro keep reporting the continuous motion; the scans
    before and after the jump are cast in one room. Returns (counts (n, 4),
    gyro (n, 3), ranges (n, n_rays), ground truth (n, 3))."""
    rng = np.random.default_rng(seed)
    freq = 40.0
    dt = 1.0 / freq
    v = np.full(n, 0.8)
    w = np.full(n, 0.25)
    theta = np.cumsum(w * dt)
    gt = np.stack([np.cumsum(v * dt * np.cos(theta)),
                   np.cumsum(v * dt * np.sin(theta)), theta], axis=1)
    T_off = _se2_T(gt[t_target]) @ np.linalg.inv(_se2_T(gt[t_kidnap]))
    gt2 = gt.copy()
    for i in range(t_kidnap, n):
        T = T_off @ _se2_T(gt[i])
        gt2[i] = [T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])]
    angles = np.linspace(np.radians(-135.0), np.radians(135.0), n_rays)
    ranges_all = _raycast_room(np.concatenate([gt, gt2]), angles, 30.0, rng)
    ranges = np.where(np.arange(n)[:, None] < t_kidnap,
                      ranges_all[:n], ranges_all[n:])
    counts = np.stack([v / (0.0022 * freq)] * 4, axis=1)
    counts += rng.normal(0, 0.05, counts.shape)
    gyro = np.zeros((n, 3))
    gyro[:, 2] = w + rng.normal(0, 2e-3, n)
    return counts, gyro, ranges, gt2


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
