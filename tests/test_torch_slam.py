"""The port's end-to-end pipeline (run_slam and the CLI) against the JAX
package's run_slam on the same synthetic log.

Contract: ICP iteration counts and loop-closure gate decisions identical,
final poses within 8e-5 (the CPU-vs-TPU parity bound of the JAX package,
PERF.md), and the port's map built from the JAX poses bit-equal to the JAX
map. float32 is the dtype of the GPU path; float64 pins the same contract
with rounding out of the way.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import odometry as jodo
from lidar_slam_tpu.models import scan_matching as jsm
from lidar_slam_tpu.models import slam as jslam
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.utils import io as jio

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.__main__ import main as cli_main
from lidar_slam_tpu_torch.kernels.nn import nn_argmin
from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.models import slam as tslam
from lidar_slam_tpu_torch.ops import scan as tscan
from lidar_slam_tpu_torch.utils import interop

torch.set_num_threads(1)

N_STEPS, N_RAYS, CHUNK = 100, 181, 16
POSE_TOL = 8e-5


def _cfg(C):
    return C.SlamConfig(
        lidar=C.LidarConfig(n_rays=N_RAYS),
        map=C.MapConfig(resolution=0.1, world_max_x=10, world_min_x=-10,
                        world_max_y=10, world_min_y=-10))


@pytest.fixture(scope="module")
def log():
    d = jio.synthetic_dataset(n_steps=N_STEPS, n_rays=N_RAYS, seed=42)
    return (d["encoder"]["counts"], d["imu"]["angular_velocity"],
            d["lidar"]["ranges"])


def _jax_run(arrays, mode, interval):
    """JAX run_slam plus the per-pair ICP iterations and loop gates it does
    not return (the same jitted calls, so cached)."""
    counts, gyro, ranges = arrays
    cfg = _cfg(jc)
    r = jslam.run_slam(counts, gyro, ranges, 0.1, 30.0, mode=mode, cfg=cfg,
                       fixed_interval=interval, chunk_size=CHUNK)
    out = {"res": r}
    pts, masks = jscan.scans_to_points(jnp.asarray(ranges), 0.1, 30.0,
                                       cfg.lidar)
    if mode != "odom":
        sm = jsm.poses_from_scan_matching(jnp.asarray(r.poses_odom), pts,
                                          masks, cfg.icp, chunk_size=CHUNK)
        out["iters"] = np.asarray(sm.iters)
    if mode == "gtsam":
        md, my = jodo.max_step_gates(jnp.asarray(counts), jnp.asarray(gyro),
                                     cfg.robot.dt)
        cand = jslam.loop_closure_candidates(N_STEPS, interval)
        _, acc, _, it = jslam.compute_loop_closures(
            jicp.lift_to_3d(pts), masks, cand, interval, float(md),
            float(my), chunk_size=CHUNK)
        out["accept"], out["loop_iters"] = np.asarray(acc), np.asarray(it)
    return out


# interval 1 makes most loop pairs pass the reference's per-step gates, so
# accepted loop factors reach the pose graph (at interval 10 this log's
# gates reject every candidate). It runs in float64: the one-iteration loop
# ICPs of scans one step apart meet float32 nearest-neighbour near-ties
# that the two frameworks' cross-term rounding resolves differently (the
# NN contract allows it), moving a loop measurement by up to 2e-3.
@pytest.mark.parametrize("mode,dt,interval", [
    ("odom", "f32", 10), ("scan_matching", "f32", 10), ("gtsam", "f32", 10),
    ("gtsam", "f64", 10), ("gtsam", "f64", 1)])
def test_run_slam_matches_jax(log, mode, dt, interval):
    npd, tdt = ((np.float64, torch.float64) if dt == "f64"
                else (np.float32, torch.float32))
    arrays = tuple(a.astype(npd) for a in log)
    with jax.enable_x64(dt == "f64"):
        j = _jax_run(arrays, mode, interval)
    jr = j["res"]
    launches = (nn_argmin.launches, raywalk_build.launches)
    tr = tslam.run_slam(*arrays, 0.1, 30.0, mode=mode, cfg=_cfg(tc),
                        fixed_interval=interval, chunk_size=CHUNK,
                        device="cpu", dtype=tdt)
    # CPU tensors run the kernels' plain versions and never launch
    assert (nn_argmin.launches, raywalk_build.launches) == launches

    assert tr.poses.dtype == jr.poses.dtype == npd
    np.testing.assert_allclose(tr.poses_odom, jr.poses_odom, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tr.poses, jr.poses, rtol=0, atol=POSE_TOL)
    if mode != "odom":
        np.testing.assert_array_equal(tr.scan_matching_iters, j["iters"])
        assert j["iters"].max() > 2
        np.testing.assert_allclose(tr.poses_scan_matching,
                                   jr.poses_scan_matching, rtol=0,
                                   atol=POSE_TOL)
    if mode == "gtsam":
        np.testing.assert_array_equal(tr.loop_accept, j["accept"])
        np.testing.assert_array_equal(tr.loop_iters, j["loop_iters"])
        assert tr.n_loop_closures == jr.n_loop_closures
        assert (tr.n_loop_closures > 50) == (interval == 1)
        assert tr.lm_iterations >= 1
        np.testing.assert_allclose(tr.poses_optimized, jr.poses_optimized,
                                   rtol=0, atol=POSE_TOL)
    assert set(tr.stage_seconds) >= {"odometry", "map_build"}

    # the port's map from the JAX poses is the JAX map, bit for bit
    pts, masks = tscan.scans_to_points(torch.from_numpy(arrays[2]), 0.1,
                                       30.0, _cfg(tc).lidar)
    g = tocc.build_logodds(interop.from_numpy(jr.poses), pts, masks,
                           _cfg(tc).map, tr.ray_cells)
    np.testing.assert_array_equal(g.numpy(), jr.logodds)
    np.testing.assert_array_equal(tocc.finalize_grid(g).numpy(),
                                  jr.grid_map)
    # and the port's own map differs only where poses differ by rounding
    assert (tr.grid_map != jr.grid_map).mean() < 1e-3


def test_cli_matches_main_py(tmp_path, monkeypatch, capsys):
    """python -m lidar_slam_tpu_torch and the JAX package's main.py on the
    same on-disk dataset: the same stage artifacts under the same names
    (plus the port's log-odds array), poses within the pipeline bound."""
    import main as jax_main
    from tests.test_driver_oracle import _write_dataset

    data = str(tmp_path / "data")
    _write_dataset(data, n_steps=40, n_rays=181)
    monkeypatch.chdir(tmp_path)
    common = ["--mode", "gtsam", "--dataset_path", data]
    jax_main.main(common + ["--output_dir", str(tmp_path / "jax")])
    rc = cli_main(common + ["--output_dir", str(tmp_path / "port"),
                            "--device", "cpu"])
    assert rc == 0
    assert "Added" in capsys.readouterr().out
    want = sorted(os.listdir(tmp_path / "jax"))
    assert len(want) == 5
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        want + ["logodds_gtsam_20.npy"])
    for name in want:
        a = np.load(tmp_path / "jax" / name)
        b = np.load(tmp_path / "port" / name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=POSE_TOL, err_msg=name)
    lo = np.load(tmp_path / "port" / "logodds_gtsam_20.npy")
    assert lo.shape == (1201, 1201) and lo.dtype == np.float32
    assert (lo < 0).sum() > 1000 and (lo > 0).sum() > 100


def test_cli_synthetic_dataset_21(tmp_path):
    out = str(tmp_path / "out")
    rc = cli_main(["--mode", "odom", "--synthetic", "30", "--dataset", "21",
                   "--device", "cpu", "--res", "0.25", "--width", "40",
                   "--height", "40", "--output_dir", out])
    assert rc == 0
    poses = np.load(os.path.join(out, "poses_odom_21.npy"))
    lo = np.load(os.path.join(out, "logodds_odom_21.npy"))
    assert poses.shape == (30, 3) and lo.shape == (161, 161)
    assert np.isfinite(poses).all() and (lo != 0).any()


@pytest.mark.parametrize("flags", [["--filter_lidar"],
                                   ["--generate_texture_map"],
                                   ["--loop_proposer", "proximity"],
                                   ["--robust_loss", "huber"],
                                   ["--icp_metric", "point_to_line"]])
def test_cli_refuses_unported_flags(flags, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--synthetic", "10", "--device", "cpu"] + flags)
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_unported_run_slam_options_raise(log):
    counts, gyro, ranges = (a[:20] for a in log)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, filter_lidar=True)
    import dataclasses
    cfg = _cfg(tc)
    bad = dataclasses.replace(cfg, pose_graph=dataclasses.replace(
        cfg.pose_graph, solver="direct"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, mode="gtsam",
                       cfg=bad)
    with pytest.raises(ValueError, match="unknown mode"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, mode="online")


def test_cuda_device_raises_without_cuda(log):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-CUDA refusal is not "
                    "reachable")
    counts, gyro, ranges = (a[:20] for a in log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--synthetic", "10", "--device", "cuda"])
