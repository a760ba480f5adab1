"""The PyTorch port stands alone: no JAX on import, and its numpy copies of
the JAX package's config, sensor and IO code give identical values."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lidar_slam_tpu.config as jcfg
from lidar_slam_tpu import sensors as jsensors
from lidar_slam_tpu.utils import io as jio

import lidar_slam_tpu_torch.config as tcfg
from lidar_slam_tpu_torch import sensors as tsensors
from lidar_slam_tpu_torch.utils import interop
from lidar_slam_tpu_torch.utils import io as tio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import lidar_slam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its main() runs only as a script)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "lidar_slam_tpu.")))
bad += ["lidar_slam_tpu"] if "lidar_slam_tpu" in sys.modules else []
assert not bad, bad
import torch
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
assert torch.get_float32_matmul_precision() == "highest"
print(len(names))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, ROOT],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every port module was imported


def _dataclasses(mod):
    return {n: c for n, c in vars(mod).items()
            if dataclasses.is_dataclass(c) and isinstance(c, type)}


def test_config_dataclasses_equal():
    jd, td = _dataclasses(jcfg), _dataclasses(tcfg)
    assert sorted(jd) == sorted(td)
    for name in jd:
        assert (dataclasses.asdict(jd[name]())
                == dataclasses.asdict(td[name]())), name
    # the derived CLI constructor and properties agree too
    jm = jcfg.MapConfig.from_cli(0.05, 60, 60)
    tm = tcfg.MapConfig.from_cli(0.05, 60, 60)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert (jm.width, jm.height) == (tm.width, tm.height)
    # the pipeline config pins the banded solver; a bare PoseGraphConfig
    # does not
    assert tcfg.SlamConfig().pose_graph.solver == "banded"


def _assert_tree_equal(a, b, path="data"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}[{k!r}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.mark.parametrize("gen,kw", [
    ("synthetic_dataset", dict(n_steps=60, n_rays=181, seed=0)),
    ("synthetic_dataset", dict(n_steps=90, n_rays=361, seed=21)),
    ("synthetic_dataset_21", dict(n_steps=50, n_rays=181)),
])
def test_synthetic_dataset_and_sync_equal(gen, kw):
    dj, dt = getattr(jio, gen)(**kw), getattr(tio, gen)(**kw)
    _assert_tree_equal(dj, dt)

    synced = []
    for mod, d in ((jsensors, dj), (tsensors, dt)):
        enc = mod.Encoder.from_data(d["encoder"])
        imu = mod.Imu.from_data(d["imu"])
        lid = mod.Lidar.from_data(d["lidar"])
        mod.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
        synced.append({"counts": enc.counts_synced, "gyro": imu.gyro_synced,
                       "ranges": lid.ranges_synced,
                       "range_min": np.asarray(lid.range_min),
                       "range_max": np.asarray(lid.range_max)})
    _assert_tree_equal(*synced)


def test_raycast_and_nearest_indices_equal():
    rng = np.random.default_rng(4)
    poses = np.cumsum(rng.normal(0, 0.1, (12, 3)), axis=0)
    angles = np.linspace(-2.3, 2.3, 97)
    np.testing.assert_array_equal(
        jio._raycast_room(poses, angles, 30.0, np.random.default_rng(1)),
        tio._raycast_room(poses, angles, 30.0, np.random.default_rng(1)))
    arr = np.sort(rng.uniform(0, 10, 200))
    vals = np.concatenate([rng.uniform(-1, 11, 300), arr[:5],
                           (arr[:-1] + arr[1:])[:5] / 2])  # exact ties
    np.testing.assert_array_equal(jio.find_nearest_indices(arr, vals),
                                  tio.find_nearest_indices(arr, vals))


def test_load_data_equal(tmp_path):
    rng = np.random.default_rng(2)
    n = 7
    np.savez(tmp_path / "Encoders20.npz", counts=rng.integers(0, 9, (4, n)),
             time_stamps=np.arange(n) * 0.025)
    np.savez(tmp_path / "Hokuyo20.npz", angle_min=-2.35, angle_max=2.35,
             angle_increment=np.array([[0.0044]]), range_min=0.1,
             range_max=30.0, ranges=rng.uniform(0, 30, (33, n)),
             time_stamps=np.arange(n) * 0.025)
    np.savez(tmp_path / "Imu20.npz", angular_velocity=rng.normal(size=(3, n)),
             linear_acceleration=rng.normal(size=(3, n)),
             time_stamps=np.arange(n) * 0.01)
    np.savez(tmp_path / "Kinect20.npz",
             disparity_time_stamps=np.arange(3.0),
             rgb_time_stamps=np.arange(3.0))
    folder = str(tmp_path)
    _assert_tree_equal(jio.load_data(20, jio.DATASET_NAMES, folder),
                       tio.load_data(20, tio.DATASET_NAMES, folder))
    with pytest.raises(ValueError, match="20 or 21"):
        tio.load_data(19, tio.DATASET_NAMES, folder)


def test_interop_round_trip_keeps_dtypes():
    from lidar_slam_tpu_torch.models.pose_graph import make_graph

    rng = np.random.default_rng(0)
    state = {"poses": rng.normal(size=(5, 3)),
             "masks": rng.random((5, 8)) > 0.5,
             "idx": np.arange(4, dtype=np.int32),
             "grid": np.zeros((3, 4), np.float32),
             "scalar": 1.5}
    t = interop.from_numpy(state)
    assert t["poses"].dtype == torch.float64
    assert t["masks"].dtype == torch.bool
    assert t["idx"].dtype == torch.int32
    assert t["grid"].dtype == torch.float32
    back = interop.to_numpy(t)
    for k in ("poses", "masks", "idx", "grid"):
        np.testing.assert_array_equal(back[k], state[k])
        assert back[k].dtype == state[k].dtype
    assert back["scalar"] == 1.5
    # a forced dtype applies to floating arrays only
    t32 = interop.from_numpy(state, dtype=torch.float32)
    assert t32["poses"].dtype == torch.float32
    assert t32["idx"].dtype == torch.int32
    # NamedTuples keep their type
    g = make_graph(torch.eye(3, dtype=torch.float64).expand(4, 3, 3))
    g_np = interop.to_numpy(g)
    assert type(g_np) is type(g) and isinstance(g_np.between_meas, np.ndarray)
    g2 = interop.from_numpy(g_np)
    assert type(g2) is type(g) and torch.equal(g2.between_meas,
                                               g.between_meas)
