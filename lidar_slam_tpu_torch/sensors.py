"""Sensor containers and vectorized time synchronization (numpy).

A copy of lidar_slam_tpu/sensors.py, which cannot be imported without JAX
(lidar_slam_tpu/__init__.py imports it). Same dataclasses and the same
nearest-stamp (first-index-on-tie) synchronization;
tests/test_torch_port_imports.py holds the synchronized arrays equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .utils.io import find_nearest_indices


@dataclasses.dataclass
class Encoder:
    """Wheel encoder counts [FR, FL, RR, RL] (reference: modules/sensors.py:51-69)."""

    counts: np.ndarray  # (N, 4)
    stamps: np.ndarray  # (N,)
    counts_synced: Optional[np.ndarray] = None
    stamps_synced: Optional[np.ndarray] = None

    @classmethod
    def from_data(cls, data: Dict) -> "Encoder":
        return cls(counts=data["counts"], stamps=data["stamps"])

    def update_synced_data(self, indices: np.ndarray) -> None:
        self.counts_synced = self.counts[indices]
        self.stamps_synced = self.stamps[indices]


@dataclasses.dataclass
class Imu:
    """IMU gyro + accelerometer (reference: modules/sensors.py:71-92)."""

    gyro: np.ndarray  # (N, 3)
    acc: np.ndarray  # (N, 3)
    stamps: np.ndarray  # (N,)
    gyro_synced: Optional[np.ndarray] = None
    acc_synced: Optional[np.ndarray] = None
    stamps_synced: Optional[np.ndarray] = None

    @classmethod
    def from_data(cls, data: Dict) -> "Imu":
        return cls(gyro=data["angular_velocity"], acc=data["linear_acceleration"],
                   stamps=data["stamps"])

    def update_synced_data(self, indices: np.ndarray) -> None:
        self.gyro_synced = self.gyro[indices]
        self.acc_synced = self.acc[indices]
        self.stamps_synced = self.stamps[indices]


@dataclasses.dataclass
class Lidar:
    """Hokuyo scans + metadata (reference: modules/sensors.py:94-118)."""

    ranges: np.ndarray  # (N, n_rays)
    stamps: np.ndarray  # (N,)
    angle_min: float = 0.0
    angle_max: float = 0.0
    angle_increment: float = 0.0
    range_min: float = 0.0
    range_max: float = 0.0
    ranges_synced: Optional[np.ndarray] = None
    stamps_synced: Optional[np.ndarray] = None

    @classmethod
    def from_data(cls, data: Dict) -> "Lidar":
        return cls(
            ranges=data["ranges"], stamps=data["stamps"],
            angle_min=float(data["angle_min"]), angle_max=float(data["angle_max"]),
            angle_increment=float(data["angle_increment"]),
            range_min=float(data["range_min"]), range_max=float(data["range_max"]),
        )

    def update_synced_data(self, indices: np.ndarray) -> None:
        self.ranges_synced = self.ranges[indices]
        self.stamps_synced = self.stamps[indices]


@dataclasses.dataclass
class Kinect:
    """Kinect disparity/RGB timestamps (reference: modules/sensors.py:120-146)."""

    disp_stamps: np.ndarray
    rgb_stamps: np.ndarray

    @classmethod
    def from_data(cls, data: Dict) -> "Kinect":
        return cls(disp_stamps=data["disp_stamps"], rgb_stamps=data["rgb_stamps"])

    def update_synced_data(self, indices: np.ndarray) -> None:
        pass

    def faster_camera_name(self) -> str:
        # reference: modules/sensors.py:132-136
        return "disp" if len(self.disp_stamps) > len(self.rgb_stamps) else "rgb"

    @staticmethod
    def get_closest_stamps(faster_sensor_stamps: np.ndarray,
                           slower_sensor_stamps: np.ndarray) -> np.ndarray:
        """For each slow stamp, the nearest fast-sensor index
        (reference: modules/sensors.py:138-146)."""
        return find_nearest_indices(faster_sensor_stamps, slower_sensor_stamps)


def synchronize_sensors(*sensors, base_sensor_index: int = 0) -> None:
    """Align every sensor to the base sensor's stamps by nearest timestamp.

    Same contract as the reference (modules/utils.py:119-138) but vectorized:
    O((N+M) log N) instead of an O(N*M) Python loop.
    """
    base = sensors[base_sensor_index]
    base_indices = np.arange(len(base.stamps))
    for i, sensor in enumerate(sensors):
        if i == base_sensor_index:
            sensor.update_synced_data(base_indices)
        else:
            sensor.update_synced_data(find_nearest_indices(sensor.stamps, base.stamps))
