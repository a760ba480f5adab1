"""The PyTorch port stands alone: no JAX on import, its numpy copies of
the JAX package's config, sensor and IO code give identical values, and its
kernel build is keyed on every file of its CUDA sources."""

import ast
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


_IMPORT_ONLINE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import lidar_slam_tpu_torch.models.online  # noqa: F401
import lidar_slam_tpu_torch.online_slam  # noqa: F401
print("jax" in sys.modules)
"""


def test_online_modules_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONLINE, ROOT],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


_IMPORT_PROBES = r"""
import sys
sys.path.insert(0, sys.argv[1])
import lidar_slam_tpu_torch.kernels.probes  # noqa: F401
import lidar_slam_tpu_torch.tools.pallas_probe  # noqa: F401
import lidar_slam_tpu_torch.tools.scatter_microbench  # noqa: F401
import lidar_slam_tpu_torch.tools.vpu_probe  # noqa: F401
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lidar_slam_tpu")))
"""


def test_probe_modules_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBES, ROOT],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_IMPORT_PARALLEL = r"""
import sys
sys.path.insert(0, sys.argv[1])
import lidar_slam_tpu_torch.ops.clamp_affine  # noqa: F401
import lidar_slam_tpu_torch.parallel.dryrun  # noqa: F401
import lidar_slam_tpu_torch.parallel.launch  # noqa: F401
import lidar_slam_tpu_torch.parallel.mesh  # noqa: F401
import lidar_slam_tpu_torch.parallel.sharding  # noqa: F401
import lidar_slam_tpu_torch.parallel.superstep  # noqa: F401
import lidar_slam_tpu_torch.tools.multichip_scaling  # noqa: F401
import multiprocessing
import torch.distributed as dist
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lidar_slam_tpu")),
      dist.is_initialized(), len(multiprocessing.active_children()))
"""


def test_parallel_modules_import_without_jax():
    """The multi-rank layer imports no JAX, and importing it starts no
    process group and no process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_PARALLEL, ROOT],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False 0"


def test_library_path_hashes_every_csrc_file(tmp_path, monkeypatch):
    """An added or edited header (.cuh) changes the library name, so a
    stale build is never reused; the nvcc sources stay the .cu files."""
    import shutil

    from lidar_slam_tpu_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    base = build.library_path()
    assert base.parent == build.BUILD_DIR
    assert base.name.startswith("libslamkernels_")
    header = csrc / "common.cuh"
    header.write_text("#pragma once\nconstexpr int kTile = 64;\n")
    added = build.library_path()
    header.write_text("#pragma once\nconstexpr int kTile = 32;\n")
    edited = build.library_path()
    assert len({base, added, edited}) == 3
    assert [p.name for p in build.sources()] == ["factors.cu", "icp.cu",
                                                 "nn.cu", "probes.cu",
                                                 "raywalk.cu", "tridiag.cu"]
    header.unlink()
    assert build.library_path() == base


@pytest.mark.parametrize("gone", [("_cuda_getDevice",),
                                  ("_cuda_getCurrentRawStream",),
                                  ("_cuda_getDevice",
                                   "_cuda_getCurrentRawStream")])
def test_cuda_raw_names_what_this_torch_lacks(monkeypatch, gone):
    """The wrappers' one reader of torch's private CUDA bindings raises,
    naming each binding a torch release lacks, instead of failing in a
    wrapper."""
    from lidar_slam_tpu_torch.kernels import build

    for name in build.RAW_CUDA:
        monkeypatch.setattr(torch._C, name, lambda *a: 0, raising=False)
    for name in gone:
        monkeypatch.delattr(torch._C, name)
    build.cuda_raw.cache_clear()
    try:
        with pytest.raises(RuntimeError) as err:
            build.cuda_raw()
        for name in build.RAW_CUDA:
            assert (f"torch._C.{name}" in str(err.value)) == (name in gone)
    finally:
        build.cuda_raw.cache_clear()


def test_cuda_raw_returns_the_bindings(monkeypatch):
    """Where torch has both bindings, cuda_raw hands back exactly them."""
    from lidar_slam_tpu_torch.kernels import build

    fakes = (lambda: 3, lambda index: 1000 + index)
    for name, fake in zip(build.RAW_CUDA, fakes):
        monkeypatch.setattr(torch._C, name, fake, raising=False)
    build.cuda_raw.cache_clear()
    try:
        get_device, raw_stream = build.cuda_raw()
        assert (get_device, raw_stream) == fakes
        assert raw_stream(get_device()) == 1003
    finally:
        build.cuda_raw.cache_clear()


def _calls(tree):
    """(dotted callee, enclosing function) of every call in a module."""
    out = []

    def visit(node, where):
        for child in ast.iter_child_nodes(node):
            inner = where
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                inner = f"{where}.{child.name}" if where else child.name
            if isinstance(child, ast.Call):
                out.append((ast.unparse(child.func), inner))
            visit(child, inner)

    visit(tree, "")
    return out


def test_kernel_wrappers_launch_through_build_entry():
    """No module under kernels/ fetches a stream object or enters a device
    context to launch: every wrapper launches through build.Entry, which
    enters torch.cuda.device only for tensors on another device, and
    torch's private CUDA bindings are read only in build.cuda_raw."""
    from lidar_slam_tpu_torch.kernels import build

    device_calls, entries = [], set()
    for path in sorted((build.PKG_DIR / "kernels").glob("*.py")):
        src = path.read_text()
        for callee, where in _calls(ast.parse(src)):
            assert not callee.endswith("current_stream"), (path.name, where)
            assert "cuda_stream" not in callee, (path.name, where)
            if callee == "torch.cuda.device":
                device_calls.append((path.name, where))
            if callee in ("build.Entry", "Entry"):
                entries.add(path.name)
        assert "_cuda_get" not in src or path.name == "build.py", path.name
    assert device_calls == [("build.py", "Entry.__call__")]
    assert entries == {"factors.py", "icp.py", "nn.py", "probes.py",
                       "raywalk.py", "tridiag.py"}


class _FakeLibrary:
    """A kernel library whose entry points record their arguments."""

    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """build.library() and build.cuda_raw() faked (current device 0, the
    raw stream of device i is 1000 + i); torch.cuda.device records the
    devices it is entered with."""
    from lidar_slam_tpu_torch.kernels import build

    lib, entered = _FakeLibrary(), []

    class Recording:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "cuda_raw",
                        lambda: (lambda: 0, lambda index: 1000 + index))
    monkeypatch.setattr(torch.cuda, "device", Recording)
    return build, lib, entered


@pytest.mark.parametrize("index,switched", [(0, []), (2, [2])])
def test_entry_switches_device_only_for_another(fake_cuda, index, switched):
    """Entry calls its C entry point with the arguments and the raw stream
    of the tensors' device, binds it once, and enters torch.cuda.device
    only when that device is not the current one."""
    build, lib, entered = fake_cuda
    entry = build.Entry("slam_probe_fill")
    entry(index, 11, 22)
    entry(index, 33, 44)
    assert lib.calls == [("slam_probe_fill", (11, 22, 1000 + index)),
                         ("slam_probe_fill", (33, 44, 1000 + index))]
    assert entered == switched * 2


def test_entry_raises_on_a_refused_launch(fake_cuda):
    """A CUDA error returned by the C entry point raises, naming it."""
    build, lib, _ = fake_cuda
    lib.rc = 9
    with pytest.raises(RuntimeError, match="slam_nn_argmin kernel launch "
                                           "failed: CUDA error 9"):
        build.Entry("slam_nn_argmin")(0, 1)


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
             "step": np.asarray(7, np.int32),
             "scalar": 1.5}
    t = interop.from_numpy(state)
    assert t["poses"].dtype == torch.float64
    assert t["step"].shape == () and t["step"].dtype == torch.int32
    assert interop.from_numpy(np.float32(2.5)).shape == ()
    assert t["masks"].dtype == torch.bool
    assert t["idx"].dtype == torch.int32
    assert t["grid"].dtype == torch.float32
    back = interop.to_numpy(t)
    for k in ("poses", "masks", "idx", "grid", "step"):
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
