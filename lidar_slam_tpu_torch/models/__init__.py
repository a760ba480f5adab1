"""Pipeline stages of the port (counterparts of lidar_slam_tpu/models)."""
