"""The port's counterparts of examples/: thin drivers over its modules, run
as `python -m lidar_slam_tpu_torch.examples.<name>`."""
