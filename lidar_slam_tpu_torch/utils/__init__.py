"""Host utilities of the port (counterparts of lidar_slam_tpu/utils)."""
