"""The port's export and metrics modules and the CLI flags of the revisit
slice, against the JAX package on the CPU.

utils/export.py and utils/metrics.py: bit-equal files and values. The gtsam
CLI's flags that the port refused before the revisit slice run and take
effect, and its --export_ros_map and --export_tum files equal main.py's
byte for byte on the same poses.
"""

import numpy as np
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.utils import export as jexport
from lidar_slam_tpu.utils import metrics as jmetrics

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.__main__ import main as cli_main
from lidar_slam_tpu_torch.models import slam as tslam
from lidar_slam_tpu_torch.utils import export as texport
from lidar_slam_tpu_torch.utils import io as tio
from lidar_slam_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def test_export_matches_jax(tmp_path):
    """utils/export.py: the ROS image, the PGM + YAML files (bytes), their
    reader and inverse, the quaternions and the TUM files (bytes, with and
    without stamps) equal to the JAX package's."""
    rng = np.random.default_rng(2)
    lo = rng.normal(0, 2, (37, 23)).astype(np.float32)
    lo[rng.random(lo.shape) < 0.3] = 0.0
    cfg_j = jc.MapConfig.from_cli(0.25, 9, 6)
    cfg_t = tc.MapConfig.from_cli(0.25, 9, 6)
    np.testing.assert_array_equal(texport.map_to_ros_image(lo),
                                  jexport.map_to_ros_image(lo))
    paths = {}
    for name, mod, cfg in (("j", jexport, cfg_j), ("t", texport, cfg_t)):
        paths[name] = mod.save_map_ros(lo, cfg, str(tmp_path / name))
    for a, b in zip(paths["t"], paths["j"]):
        data_t, data_j = open(a, "rb").read(), open(b, "rb").read()
        assert data_t.replace(b"t.pgm", b"j.pgm") == data_j
    img_t, meta_t = texport.load_map_ros(paths["t"][1])
    img_j, meta_j = jexport.load_map_ros(paths["j"][1])
    np.testing.assert_array_equal(img_t, img_j)
    assert {**meta_t, "image": "j.pgm"} == meta_j
    np.testing.assert_array_equal(texport.ros_image_to_grid(img_t),
                                  jexport.ros_image_to_grid(img_j))
    poses = rng.normal(0, 3, (25, 3))
    np.testing.assert_array_equal(texport.yaw_to_quaternion(poses[:, 2]),
                                  jexport.yaw_to_quaternion(poses[:, 2]))
    for stamps in (None, 1e9 + np.arange(25) / 40.0):
        a = texport.save_trajectory_tum(str(tmp_path / "t.txt"), poses,
                                        stamps)
        b = jexport.save_trajectory_tum(str(tmp_path / "j.txt"), poses,
                                        stamps)
        assert open(a, "rb").read() == open(b, "rb").read()
        for x, y in zip(texport.load_trajectory_tum(a),
                        jexport.load_trajectory_tum(b)):
            np.testing.assert_array_equal(x, y)


def test_metrics_match_jax():
    """utils/metrics.py: ATE (aligned and raw), RPE at two deltas and map
    agreement equal to the JAX package's, value for value."""
    rng = np.random.default_rng(3)
    ref = np.cumsum(rng.normal(0, 0.1, (80, 3)), 0)
    est = ref + rng.normal(0, 0.05, (80, 3)) + [0.3, -0.2, 0.0]
    for align in (True, False):
        assert (tmetrics.ate_translation(est, ref, align)
                == jmetrics.ate_translation(est, ref, align))
    for delta in (1, 7):
        assert (tmetrics.relative_pose_error(est, ref, delta)
                == jmetrics.relative_pose_error(est, ref, delta))
    a = rng.normal(0, 2, (40, 30))
    b = a + rng.normal(0, 0.5, a.shape)
    assert tmetrics.map_agreement(a, b) == jmetrics.map_agreement(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        tmetrics.ate_translation(est[:5], ref)


SMALL_MAP = ["--res", "0.25", "--width", "40", "--height", "40"]


@pytest.mark.parametrize("flags,check", [
    (["--loop_proposer", "proximity"],
     lambda c: c.pose_graph.loop_proposer == "proximity"),
    (["--robust_loss", "huber"],
     lambda c: c.pose_graph.robust_loss == "huber"),
    (["--icp_metric", "point_to_line"],
     lambda c: c.icp.metric == "point_to_line"),
    (["--synthetic_revisit", "24", "--synthetic_laps", "2"], None),
    (["--proximity_seed", "estimate"],
     lambda c: c.pose_graph.proximity_seed == "estimate"),
    (["--proximity_trim", "0.55"],
     lambda c: c.pose_graph.proximity_trim == 0.55),
    (["--export_ros_map", "m"], None),
    (["--export_tum", "t.txt"], None),
])
def test_cli_runs_lifted_flags(flags, check, tmp_path, monkeypatch):
    """Each flag the gtsam CLI refused until the revisit slice now runs
    (gtsam mode on a 24-step synthetic revisit log) and takes effect: the
    config run_slam receives, the revisit log's odometry, or the exported
    map and trajectory (equal to export's own writers on the run's
    result)."""
    monkeypatch.chdir(tmp_path)
    seen = {}
    real = tslam.run_slam

    def spy(*a, **kw):
        seen["cfg"] = kw["cfg"]
        seen["res"] = real(*a, **kw)
        return seen["res"]

    monkeypatch.setattr(tslam, "run_slam", spy)
    base = ["--mode", "gtsam", "--device", "cpu", "--output_dir", "out",
            *SMALL_MAP]
    if "--synthetic_revisit" not in flags:
        base += ["--synthetic_revisit", "24"]
    assert cli_main(base + flags) == 0
    cfg, res = seen["cfg"], seen["res"]
    if check is not None:
        assert check(cfg)
    elif flags[0] == "--synthetic_revisit":
        d = tio.synthetic_revisit_dataset(n_steps=24, laps=2)
        odo = np.load("out/poses_odom_20.npy")
        assert odo.shape == (24, 3)
        np.testing.assert_allclose(odo[-1, 2], d["ground_truth"][-1, 2] * 0.97,
                                   atol=0.05)
    elif flags[0] == "--export_ros_map":
        texport.save_map_ros(res.logodds, cfg.map, "want")
        for ext in (".pgm", ".yaml"):
            want = open("want" + ext, "rb").read().replace(b"want.pgm",
                                                            b"m.pgm")
            assert open("m" + ext, "rb").read() == want
    else:
        want = texport.save_trajectory_tum("want.txt", res.poses_optimized)
        got = texport.load_trajectory_tum("t.txt")
        np.testing.assert_array_equal(got[1], texport.load_trajectory_tum(
            want)[1])
        # the encoder's stamps, written to the microsecond
        np.testing.assert_allclose(np.diff(got[0]), 0.025, rtol=0, atol=1e-6)


def test_cli_exports_match_main_py(tmp_path, monkeypatch):
    """--export_ros_map and --export_tum against main.py's on the same
    on-disk dataset and the same poses (--load_poses of the port's
    odometry run, so both build the same map): the TUM files, the PGM and
    the YAML byte for byte."""
    import main as jax_main
    from tests.test_driver_oracle import _write_dataset

    data = str(tmp_path / "data")
    _write_dataset(data, n_steps=40, n_rays=181)
    monkeypatch.chdir(tmp_path)
    common = ["--dataset_path", data, *SMALL_MAP]
    assert cli_main(common + ["--output_dir", "odom", "--device",
                              "cpu"]) == 0
    common += ["--load_poses", "odom/poses_odom_20.npy"]
    jax_main.main(common + ["--export_ros_map", "jm", "--export_tum",
                            "j.txt"])
    assert cli_main(common + ["--export_ros_map", "tm", "--export_tum",
                              "t.txt", "--device", "cpu"]) == 0
    assert open("t.txt", "rb").read() == open("j.txt", "rb").read()
    assert open("tm.pgm", "rb").read() == open("jm.pgm", "rb").read()
    assert (open("tm.yaml").read().replace("tm.pgm", "jm.pgm")
            == open("jm.yaml").read())
    img, _ = texport.load_map_ros("tm.yaml")
    assert (img == 0).sum() > 20 and (img == 254).sum() > 100
