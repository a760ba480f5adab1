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
    same on-disk dataset: every main.py flag under its name and default,
    the same stage artifacts under the same names (no map without
    --save_logodds), poses within the pipeline bound."""
    import main as jax_main
    from lidar_slam_tpu_torch.__main__ import build_parser
    from tests.test_driver_oracle import _write_dataset

    want_flags = {a.dest: a.default for a in jax_main.build_parser()._actions}
    have = {a.dest: a.default for a in build_parser()._actions}
    assert len(want_flags) == 25
    assert {k: have.get(k, "missing") for k in want_flags} == want_flags
    assert set(have) - set(want_flags) == {"device"}

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
    assert sorted(os.listdir(tmp_path / "port")) == want
    for name in want:
        a = np.load(tmp_path / "jax" / name)
        b = np.load(tmp_path / "port" / name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=POSE_TOL, err_msg=name)
    assert sorted(os.listdir(tmp_path)) == ["data", "jax", "port"]


def test_cli_synthetic_dataset_21(tmp_path):
    out = str(tmp_path / "out")
    grid = str(tmp_path / "grid.npy")
    rc = cli_main(["--mode", "odom", "--synthetic", "30", "--dataset", "21",
                   "--device", "cpu", "--res", "0.25", "--width", "40",
                   "--height", "40", "--output_dir", out,
                   "--save_logodds", grid])
    assert rc == 0
    poses = np.load(os.path.join(out, "poses_odom_21.npy"))
    lo = np.load(grid)
    assert poses.shape == (30, 3) and lo.shape == (161, 161)
    assert np.isfinite(poses).all() and (lo != 0).any()


SMALL_MAP = ["--res", "0.25", "--width", "40", "--height", "40"]


def test_cli_writes_the_map_only_to_save_logodds(tmp_path):
    """main.py's rule: no map without an output that reads it; with
    --save_logodds, run_slam's grid at that path and nowhere else."""
    from lidar_slam_tpu_torch import sensors as tsens
    from lidar_slam_tpu_torch.utils import io as tio

    base = ["--mode", "scan_matching", "--synthetic", "30", "--device",
            "cpu", *SMALL_MAP]
    assert cli_main(base + ["--output_dir", str(tmp_path / "a")]) == 0
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        f"{p}poses_{m}_20.npy" for p in ("", "relative_")
        for m in ("odom", "scan_matching"))
    grid = str(tmp_path / "map" / "grid.npy")
    assert cli_main(base + ["--output_dir", str(tmp_path / "b"),
                            "--save_logodds", grid]) == 0
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        os.listdir(tmp_path / "a"))
    assert os.listdir(tmp_path / "map") == ["grid.npy"]

    d = tio.synthetic_dataset(n_steps=30)
    enc = tsens.Encoder.from_data(d["encoder"])
    lid = tsens.Lidar.from_data(d["lidar"])
    imu = tsens.Imu.from_data(d["imu"])
    tsens.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
    want = tslam.run_slam(
        enc.counts_synced, imu.gyro_synced, lid.ranges_synced,
        float(lid.range_min), float(lid.range_max), mode="scan_matching",
        cfg=tc.SlamConfig(map=tc.MapConfig.from_cli(0.25, 40, 40)),
        device="cpu")
    got = np.load(grid)
    assert got.dtype == np.float32 and (got < 0).sum() > 100
    np.testing.assert_array_equal(got, want.logodds)


def test_cli_load_poses_matches_jax_resume(tmp_path, monkeypatch):
    """--load_poses on the port's saved scan-matching poses: the map of
    JAX main.py --load_poses (lidar_slam_tpu.models.slam.resume_from_poses)
    on the same dataset and poses, bit for bit, and the first run's map;
    no stage artifacts on resume."""
    import main as jax_main
    from tests.test_driver_oracle import _write_dataset

    data = str(tmp_path / "data")
    _write_dataset(data, n_steps=40, n_rays=181)
    monkeypatch.chdir(tmp_path)
    common = ["--dataset_path", data, *SMALL_MAP]
    first, resumed = str(tmp_path / "first.npy"), str(tmp_path / "res.npy")
    assert cli_main(common + ["--mode", "scan_matching", "--device", "cpu",
                              "--output_dir", "port", "--save_logodds",
                              first]) == 0
    poses = str(tmp_path / "port" / "poses_scan_matching_20.npy")
    assert cli_main(common + ["--load_poses", poses, "--device", "cpu",
                              "--output_dir", "resume", "--save_logodds",
                              resumed]) == 0
    assert not os.path.exists(tmp_path / "resume")
    jax_grid = str(tmp_path / "jax.npy")
    jax_main.main(common + ["--load_poses", poses, "--output_dir", "jaxout",
                            "--save_logodds", jax_grid])
    got, want = np.load(resumed), np.load(jax_grid)
    assert got.shape == (161, 161) and (got < 0).sum() > 100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.load(first))


def test_resume_from_poses_matches_jax(log):
    """resume_from_poses against the JAX function on the same float32
    poses and ranges: relative poses within the pipeline bound, the map bit
    for bit; build_map=False builds nothing."""
    counts, gyro, ranges = (a[:40].astype(np.float32) for a in log)
    poses = jodo.poses_from_odometry(jnp.asarray(counts),
                                     jnp.asarray(gyro))
    poses = np.array(poses, dtype=np.float32)
    want = jslam.resume_from_poses(poses, ranges, 0.1, 30.0, cfg=_cfg(jc))
    got = tslam.resume_from_poses(poses, ranges, 0.1, 30.0, cfg=_cfg(tc),
                                  device="cpu")
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_allclose(got.relative_poses_odom,
                               want.relative_poses_odom, rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_array_equal(got.logodds, want.logodds)
    np.testing.assert_array_equal(got.grid_map, want.grid_map)
    assert (want.logodds != 0).sum() > 1000
    bare = tslam.resume_from_poses(poses, ranges, 0.1, 30.0, cfg=_cfg(tc),
                                   build_map=False, device="cpu")
    assert bare.logodds is None and bare.grid_map is None


def test_cli_image_paths_follow_main_py():
    """main.py:153-160's derivation of the two map image paths."""
    from lidar_slam_tpu_torch.__main__ import build_parser, image_paths

    p = build_parser()
    assert image_paths(p.parse_args(["--mode", "gtsam"])) == (
        "images/logodds_map_gtsam_20.png", "images/texture_map_gtsam_20.png")
    assert image_paths(p.parse_args(
        ["--filter_lidar", "--dataset", "21", "--logodds_map_path", "a.b.png",
         "--texture_map_path", "t.jpg"])) == (
        "images_filtered/a_odom_21.png", "images_filtered/t_odom_21.png")


@pytest.mark.parametrize("flags", [["--loop_proposer", "proximity"],
                                   ["--robust_loss", "huber"],
                                   ["--icp_metric", "point_to_line"],
                                   ["--synthetic_revisit", "50"],
                                   ["--proximity_seed", "estimate"],
                                   ["--proximity_trim", "0.55"],
                                   ["--export_ros_map", "m"],
                                   ["--export_tum", "t.txt"]])
def test_cli_refuses_unported_flags(flags, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--synthetic", "10", "--device", "cpu"] + flags)
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_unported_run_slam_options_raise(log):
    counts, gyro, ranges = (a[:20] for a in log)
    import dataclasses
    cfg = _cfg(tc)
    bad = dataclasses.replace(cfg, pose_graph=dataclasses.replace(
        cfg.pose_graph, solver="direct"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, mode="gtsam",
                       cfg=bad, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, mode="online")


def test_cuda_device_raises_without_cuda(log, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-CUDA refusal is not "
                    "reachable")
    counts, gyro, ranges = (a[:20] for a in log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--synthetic", "10", "--device", "cuda"])
    # the entry points default to the card: called without a device they
    # refuse a host without one instead of running on the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tslam.run_slam(counts, gyro, ranges, 0.1, 30.0, mode="gtsam")
    from lidar_slam_tpu_torch.models import online as ton

    cfg = _cfg(tc)
    pts, masks = tscan.scans_to_points(
        torch.as_tensor(ranges, dtype=torch.float32), 0.1, 30.0, cfg.lidar)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ton.init_state(pts[0], masks[0], cfg, K=64)
    st = ton.init_state(pts[0], masks[0], cfg, n_max=16, K=64, device="cpu")
    path = str(tmp_path / "ck.npz")
    ton.save_state(path, st)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ton.load_state(path)


# main.py's filter settings (eps = 0.1 m) need full 1,081-ray scans: DBSCAN
# marks nearly every point of a sparser scan as noise. At full width the
# port's and JAX's scan-matching poses part by up to 4e-3 whether or not
# the filters run (float32 near-ties and scan points a ULP apart), so the
# filtered gtsam path is held to POSE_TOL on the file's 181-ray log with
# settings scaled to its ray spacing, and the CLI at full width in odom
# mode.
FULL_RAYS = 1081
SPARSE_FILTER = dict(dbscan_eps=0.7, dbscan_min_samples=5,
                     statistical_k_std=1.0)


def _synced_log(n_steps, seed):
    from lidar_slam_tpu_torch import sensors as tsens
    from lidar_slam_tpu_torch.utils import io as tio

    d = tio.synthetic_dataset(n_steps=n_steps, n_rays=FULL_RAYS, seed=seed)
    enc = tsens.Encoder.from_data(d["encoder"])
    lid = tsens.Lidar.from_data(d["lidar"])
    imu = tsens.Imu.from_data(d["imu"])
    tsens.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
    return (enc.counts_synced.astype(np.float32),
            imu.gyro_synced.astype(np.float32),
            lid.ranges_synced.astype(np.float32))


def test_run_slam_filter_lidar_matches_jax(log):
    """run_slam(mode="gtsam", filter_lidar=True) against JAX's on the
    181-ray log: the filtered masks equal, poses within POSE_TOL, the same
    loop decisions, and the port's map from the JAX poses equal to the JAX
    map bit for bit; both filters dropped points."""
    import dataclasses

    arrays = tuple(a.astype(np.float32) for a in log)
    cfg_j = dataclasses.replace(_cfg(jc),
                                filter=jc.FilterConfig(**SPARSE_FILTER))
    cfg_t = dataclasses.replace(_cfg(tc),
                                filter=tc.FilterConfig(**SPARSE_FILTER))
    jr = jslam.run_slam(*arrays, 0.1, 30.0, mode="gtsam", filter_lidar=True,
                        cfg=cfg_j, chunk_size=CHUNK)
    tr = tslam.run_slam(*arrays, 0.1, 30.0, mode="gtsam", filter_lidar=True,
                        cfg=cfg_t, chunk_size=CHUNK, device="cpu")
    assert "filter" in tr.stage_seconds
    for name in ("poses_odom", "poses_scan_matching", "poses_optimized"):
        np.testing.assert_allclose(getattr(tr, name), getattr(jr, name),
                                   rtol=0, atol=POSE_TOL, err_msg=name)
    assert tr.n_loop_closures == jr.n_loop_closures
    pts, masks = tscan.scans_to_points(torch.from_numpy(arrays[2]), 0.1,
                                       30.0, cfg_t.lidar)
    kept = tslam.filter_scans(pts, masks, cfg_t)
    jpts, jmasks = jscan.scans_to_points(jnp.asarray(arrays[2]), 0.1, 30.0,
                                         cfg_j.lidar)
    from lidar_slam_tpu.ops import filters as jf

    jdb = jf.dbscan_filter_scans(jpts, jmasks, eps=0.7, min_samples=5)
    np.testing.assert_array_equal(
        kept.numpy(), np.asarray(jf.statistical_filter_scans(jpts, jdb,
                                                             k_std=1.0)))
    assert int(masks.sum()) > int(jdb.sum()) > int(kept.sum()) > 0
    g = tocc.build_logodds(interop.from_numpy(jr.poses), pts, kept,
                           cfg_t.map, tr.ray_cells)
    np.testing.assert_array_equal(g.numpy(), jr.logodds)
    assert (tr.grid_map != jr.grid_map).mean() < 1e-3


def test_cli_filter_lidar_matches_main_py(tmp_path, monkeypatch):
    """--filter_lidar at main.py's settings on the same on-disk full-width
    dataset (odom mode): the port's stage artifacts within the odometry
    bound (1e-6) of main.py's, and its map within the file's own-poses
    bound (1e-3 of the cells)."""
    import main as jax_main
    from tests.test_driver_oracle import _write_dataset

    data = str(tmp_path / "data")
    _write_dataset(data, n_steps=40, n_rays=FULL_RAYS)
    monkeypatch.chdir(tmp_path)
    common = ["--filter_lidar", "--dataset_path", data, *SMALL_MAP]
    jax_main.main(common + ["--output_dir", "jax", "--save_logodds",
                            "jax.npy"])
    assert cli_main(common + ["--output_dir", "port", "--save_logodds",
                              "port.npy", "--device", "cpu"]) == 0
    want = sorted(os.listdir(tmp_path / "jax"))
    assert len(want) == 2 and sorted(os.listdir(tmp_path / "port")) == want
    for name in want:
        np.testing.assert_allclose(np.load(tmp_path / "port" / name),
                                   np.load(tmp_path / "jax" / name), rtol=0,
                                   atol=1e-6, err_msg=name)
    got, ref = (tocc.finalize_grid(torch.from_numpy(np.load(f))).numpy()
                for f in ("port.npy", "jax.npy"))
    assert (got != ref).mean() < 1e-3 and (got == 0).sum() > 100


def test_cli_load_poses_filter_lidar_matches_jax_resume(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """--load_poses --filter_lidar --generate_texture_map --synthetic 40:
    the grid of JAX main.py's resume bit for bit, its log-odds PNG byte for
    byte at main.py's path, and main.py's "skipping texture" line."""
    import main as jax_main

    monkeypatch.chdir(tmp_path)
    poses = jodo.poses_from_odometry(
        *(jnp.asarray(a) for a in _synced_log(40, 0)[:2]))
    np.save("poses.npy", np.asarray(poses, np.float32))
    common = ["--synthetic", "40", "--load_poses", "poses.npy",
              "--filter_lidar", "--generate_texture_map", *SMALL_MAP]
    jax_main.main(common + ["--save_logodds", "jax.npy"])
    png = tmp_path / "images_filtered" / "logodds_map_odom_20.png"
    want_png = png.read_bytes()
    png.unlink()
    capsys.readouterr()
    assert cli_main(common + ["--save_logodds", "port.npy", "--device",
                              "cpu"]) == 0
    assert "skipping texture" in capsys.readouterr().out
    got, want = np.load("port.npy"), np.load("jax.npy")
    np.testing.assert_array_equal(got, want)
    assert (got < 0).sum() > 100
    assert png.read_bytes() == want_png
    unfiltered = tslam.resume_from_poses(
        np.load("poses.npy"), _synced_log(40, 0)[2], 0.1, 30.0,
        cfg=tc.SlamConfig(map=tc.MapConfig.from_cli(0.25, 40, 40)),
        device="cpu")
    assert not np.array_equal(unfiltered.logodds, got)


def test_cli_generate_texture_map_matches_jax(tmp_path, monkeypatch):
    """--generate_texture_map on a dataset on disk with its RGB-D frames
    (dataRGBD/, 480 x 640): the log-odds PNG byte for byte as JAX main.py
    writes it from the same poses, and the texture PNG that of JAX's
    generate_texture_map(projector="device") on the same frames, poses and
    grid."""
    import main as jax_main
    from lidar_slam_tpu import sensors as jsens
    from lidar_slam_tpu.models import occupancy as jocc
    from lidar_slam_tpu.models import texture as jtex
    from lidar_slam_tpu_torch.utils.png import write_png
    from tests.test_driver_oracle import _write_dataset

    data = str(tmp_path / "data")
    n_rgb = 3
    _write_dataset(data, n_steps=40, n_rays=181, n_rgb=n_rgb)
    rng = np.random.default_rng(5)
    for k in range(int(n_rgb * 1.2) + 1):
        write_png(str(tmp_path / "dataRGBD" / "Disparity20"
                      / f"disparity20_{k}.png"),
                  rng.integers(400, 900, (480, 640)).astype(np.uint16))
    for i in range(1, n_rgb + 1):
        write_png(str(tmp_path / "dataRGBD" / "RGB20" / f"rgb20_{i}.png"),
                  rng.integers(0, 255, (480, 640, 3)).astype(np.uint8))
    monkeypatch.chdir(tmp_path)
    common = ["--dataset_path", data, *SMALL_MAP]
    assert cli_main(common + ["--mode", "odom", "--output_dir", "out",
                              "--device", "cpu"]) == 0
    flags = common + ["--load_poses", "out/poses_odom_20.npy",
                      "--generate_texture_map", "--save_logodds"]
    jax_main.main(flags + ["jax.npy"])
    os.rename("images", "images_jax")
    assert cli_main(flags + ["port.npy", "--device", "cpu"]) == 0
    name = "logodds_map_odom_20.png"
    assert ((tmp_path / "images" / name).read_bytes()
            == (tmp_path / "images_jax" / name).read_bytes())

    d = jax_main.build_parser()  # noqa: F841  (main.py's own stamps below)
    from lidar_slam_tpu.utils import io as jio_

    raw = jio_.load_data(20, jio_.DATASET_NAMES, data)
    enc = jsens.Encoder.from_data(raw["encoder"])
    kin = jsens.Kinect.from_data(raw["rgbd"])
    rgb_pose = jsens.Kinect.get_closest_stamps(enc.stamps, kin.rgb_stamps)
    disp_for = jsens.Kinect.get_closest_stamps(kin.disp_stamps,
                                               kin.rgb_stamps)
    grid = np.asarray(jocc.finalize_grid(jnp.asarray(np.load("jax.npy"))))
    want = jtex.generate_texture_map(
        np.load("out/poses_odom_20.npy"), rgb_pose, disp_for, grid,
        jtex.disk_frame_loader(20, disp_for), jc.MapConfig.from_cli(
            0.25, 40, 40), jc.CameraConfig(), projector="device")
    jtex.plot_texture_map(want, str(tmp_path / "want.png"))
    got = (tmp_path / "images" / "texture_map_odom_20.png").read_bytes()
    assert got == (tmp_path / "want.png").read_bytes()
    assert ((want * 255).astype(np.uint8) != grid[..., None]).any(-1).sum() > 50
