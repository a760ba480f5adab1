"""The multi-rank layer (counterpart of lidar_slam_tpu/parallel): the rank
mesh and its collectives (mesh), the launcher (launch), the sharded paths
(sharding), the fused SLAM step (superstep) and the dry run (dryrun). One
process a rank over torch.distributed; nothing here starts a process or a
process group at import."""
