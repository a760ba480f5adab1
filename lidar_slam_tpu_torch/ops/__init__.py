"""Tensor ops of the port (counterparts of lidar_slam_tpu/ops)."""
