"""The port's host C++ runtime (utils/native.py over csrc_host/) and the
texture's native and auto engines, on the CPU.

Contract: the native PNG decoders (one file, and the threaded batch) equal
the port's Python decoder; project_frames equal, bit for bit, to the JAX
package's native.project_frames (the same C++) for 1, 2 and 4 threads and
to a numpy transcription of its chain (tests/torch_texture_engines.py);
the KD-tree equal to a float64 brute force with the lowest index on
ties, and the DBSCAN to sklearn's and the JAX package's; the native, auto
and device textures equal to JAX's native engine on tests/test_texture.py's
scenes, whatever the upload grouping; where the device and native chains
part on a full-size frame, each pixel lies within 1e-4 cells (or
registration rows) of a boundary (JAX texture.py:288-293); and processes
that build the libraries at once each load a whole one.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import texture as jtex
from lidar_slam_tpu.utils import native as jnative

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import texture as ttex
from lidar_slam_tpu_torch.utils import native, png
from tests.test_texture import _np_texture_reference
from tests.torch_texture_engines import (BOUNDARY_CELLS, engines_apart,
                                         native_chain_pixels, packed_colors)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_native():
    """The JAX package's native module with its library loaded. Its loader
    runs `make -C native` at first use and keeps a failed load for the
    process's life; where another test process was writing the library at
    that moment, load it again now."""
    if jnative._LIB is None:
        jnative._TRIED = False
    assert jnative.available(), "the JAX package's native library"
    return jnative


def _filtered_png(path, img: np.ndarray, ftype: int) -> None:
    """Write an 8-bit gray/RGB or 16-bit gray PNG whose every scanline has
    filter `ftype` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h = img.shape[0]
    depth = 16 if img.dtype == np.uint16 else 8
    color = 0 if img.ndim == 2 else 2
    raw = (img.astype(">u2") if depth == 16 else img).reshape(h, -1)
    rows = raw.view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = (1 if color == 0 else 3) * depth // 8
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if ftype == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [0, left, up, (left + up) >> 1][ftype]
        out.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    w = img.shape[1]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["u8_gray", "u8_rgb", "u16_gray"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_native_png_decode_equals_python(tmp_path, kind, ftype):
    rng = np.random.default_rng(ftype)
    shape = (13, 17) if kind != "u8_rgb" else (13, 17, 3)
    dtype = np.uint16 if kind == "u16_gray" else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    path = str(tmp_path / "a.png")
    _filtered_png(path, img, ftype)
    got = native.read_png(path)
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_array_equal(got, png.read_png_python(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("threads", [1, 3])
def test_native_batch_loader(tmp_path, threads):
    """The threaded batch decode equal to the Python decoder file by file;
    a file of another shape or a missing one raises."""
    rng = np.random.default_rng(7)
    disp = rng.integers(0, 65535, (5, 12, 14)).astype(np.uint16)
    rgb = rng.integers(0, 255, (5, 12, 14, 3)).astype(np.uint8)
    dpaths, rpaths = [], []
    for k in range(5):
        dpaths.append(str(tmp_path / f"d{k}.png"))
        rpaths.append(str(tmp_path / f"r{k}.png"))
        png.write_png(dpaths[-1], disp[k])
        png.write_png(rpaths[-1], rgb[k])
    d = native.read_png_batch(dpaths, (12, 14), np.uint16, n_threads=threads)
    r = native.read_png_batch(rpaths, (12, 14, 3), np.uint8, n_threads=threads)
    np.testing.assert_array_equal(d, np.stack([png.read_png_python(p)
                                               for p in dpaths]))
    np.testing.assert_array_equal(r, rgb)
    with pytest.raises(ValueError, match="does not match"):
        native.read_png_batch(dpaths, (12, 13), np.uint16)
    with pytest.raises(IOError):
        native.read_png_batch([dpaths[0], str(tmp_path / "nope.png")],
                              (12, 14), np.uint16)


def test_disk_frame_loader_takes_the_native_batch(tmp_path, monkeypatch):
    """Where libpng built, disk_frame_loader decodes through the threaded
    batch (load.engine "native"), equal to the Python decoder."""
    rng = np.random.default_rng(6)
    disp = rng.integers(0, 65535, (3, 6, 8)).astype(np.uint16)
    rgb = rng.integers(0, 255, (2, 6, 8, 3)).astype(np.uint8)
    for k in range(3):
        png.write_png(str(tmp_path / "dataRGBD" / "Disparity20"
                          / f"disparity20_{k}.png"), disp[k])
    for i in range(2):
        png.write_png(str(tmp_path / "dataRGBD" / "RGB20"
                          / f"rgb20_{i + 1}.png"), rgb[i])
    monkeypatch.chdir(tmp_path)
    load = ttex.disk_frame_loader(20, np.array([2, 0]))
    assert native.png_available() and load.engine == "native"
    d, r = load(np.array([0, 1]))
    np.testing.assert_array_equal(d, disp[[2, 0]])
    np.testing.assert_array_equal(r, rgb)
    load.engine = "python"
    for a, b in zip(load(np.array([1, 0])), (disp[[0, 2]], rgb[[1, 0]])):
        np.testing.assert_array_equal(a, b)


def _map(C, res=0.1, half=8):
    return C.MapConfig(resolution=res, world_max_x=half, world_min_x=-half,
                       world_max_y=half, world_min_y=-half)


def _projector_scene(name):
    """tests/test_texture.py's native-projector scenes: (disp, rgb, poses,
    rgb_pose, the generator that draws the grid next, res, half)."""
    if name == "spec":  # test_native_projector_matches_spec
        rng = np.random.default_rng(21)
        disp = rng.integers(300, 900, (5, 24, 32)).astype(np.uint16)
        rgb = rng.integers(0, 255, (5, 24, 32, 3)).astype(np.uint8)
        poses = rng.normal(0, 1.0, (10, 3))
        return disp, rgb, poses, np.array([1, 3, 5, 7, 9]), rng, 0.1, 8
    if name == "grouped":  # test_native_projector_grouped_uploads_equal
        rng = np.random.default_rng(7)
        disp = rng.integers(300, 900, (10, 24, 32)).astype(np.uint16)
        rgb = rng.integers(0, 255, (10, 24, 32, 3)).astype(np.uint8)
        return disp, rgb, rng.normal(0, 1.0, (10, 3)), np.arange(10), rng, \
            0.1, 8
    # test_native_projector_thread_count_bit_equality, invalid pixels too
    rng = np.random.default_rng(33)
    disp = rng.integers(300, 900, (7, 48, 64)).astype(np.uint16)
    disp[rng.random((7, 48, 64)) < 0.05] = 0
    rgb = rng.integers(0, 255, (7, 48, 64, 3)).astype(np.uint8)
    return disp, rgb, rng.normal(0, 2.0, (7, 3)), np.arange(7), rng, 0.1, 10


SCENES = ["spec", "grouped", "threads"]


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_project_frames_equals_jax(jax_native, scene, threads):
    disp, rgb, poses, idx, _, res, half = _projector_scene(scene)
    pb = poses[idx]
    got = native.project_frames(disp, rgb, pb, tc.CameraConfig(),
                                _map(tc, res, half), n_threads=threads)
    want = jax_native.project_frames(disp, rgb, pb, jc.CameraConfig(),
                                     _map(jc, res, half), n_threads=threads)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_project_frames_equals_its_numpy_transcription():
    """The library against native_chain_pixels (the record script's
    transcription) with the last pixel of each cell winning, frame by
    frame, on a full-size 480 x 640 frame at 0.05 m and the threads
    scene."""
    cam, m = tc.CameraConfig(), tc.MapConfig()
    rng = np.random.default_rng(30)
    disp = rng.integers(300, 800, (2, 480, 640)).astype(np.uint16)
    disp[0, :5] = 0  # invalid depth
    rgb = rng.integers(0, 255, (2, 480, 640, 3)).astype(np.uint8)
    poses = np.asarray(rng.normal(0, 5.0, (2, 3)), np.float32)
    cells, colors = native.project_frames(disp, rgb, poses, cam, m)
    off = 0
    for f in range(2):
        cell, src, *_ = native_chain_pixels(disp[f], poses[f], cam, m)
        rev = np.nonzero(cell >= 0)[0][::-1]
        uniq, last = np.unique(cell[rev], return_index=True)
        n = len(uniq)
        order = np.argsort(cells[off:off + n])
        np.testing.assert_array_equal(cells[off:off + n][order], uniq)
        np.testing.assert_array_equal(colors[off:off + n][order],
                                      packed_colors(rgb[f])[src[rev[last]]])
        off += n
    assert off == len(cells) > 500


def test_engines_part_only_at_boundaries():
    """chip_smoke.py [13]'s first 16 frames (480 x 640, 1201 x 1201 at
    0.05 m): the device (float32) and native (float64) chains send a few
    pixels of each frame to another cell or colour them from another
    source pixel; each such pixel lies within BOUNDARY_CELLS of a cell
    boundary or a registration row boundary in the float64 chain, and each
    cell whose composed texture differs was reached by one (JAX's
    measure-zero boundary case, texture.py:288-293)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cfg = tc.SlamConfig()
    poses, loader = chip_smoke.texture_frames()
    ids = np.arange(16)
    disp, rgb = loader(ids)
    touched, n_px = set(), 0
    for f in ids:
        px, dist, cells = engines_apart(disp[f], rgb[f], poses[f],
                                        cfg.camera, cfg.map)
        assert dist.max(initial=0.0) <= BOUNDARY_CELLS
        n_px += len(px)
        touched.update(cells.tolist())
    assert n_px > 100  # about 20 pixels a frame of 307,200
    grid = np.zeros((cfg.map.width, cfg.map.height), np.uint8)
    tex = {e: ttex.generate_texture_map(poses, ids, ids, grid, loader,
                                        cfg.map, cfg.camera, projector=e,
                                        device="cpu")[0]
           for e in ("device", "native")}
    apart = np.nonzero((tex["device"] != tex["native"]).any(-1)
                       .reshape(-1).numpy())[0]
    assert set(apart.tolist()) <= touched


def _textures(scene, engine, **kw):
    disp, rgb, poses, idx, rng, res, half = _projector_scene(scene)
    m = _map(tc, res, half)
    grid = rng.integers(0, 2, (m.width, m.height)).astype(np.uint8)
    n = len(idx)
    tex, got = ttex.generate_texture_map(
        poses, idx, np.arange(n), grid, lambda ids: (disp[ids], rgb[ids]), m,
        tc.CameraConfig(), batch_size=2, projector=engine, device="cpu",
        **kw)
    return tex, got, (poses, idx, disp, rgb, grid, res, half)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("engine", ["native", "auto", "device"])
def test_texture_engines_equal_jax_native(jax_native, scene, engine):
    """Each engine's texture equal to JAX's generate_texture_map(projector=
    "native") bit for bit on the scene, and to the numpy spec model within
    1e-6; auto reports native for the integer disparity."""
    tex, got, (poses, idx, disp, rgb, grid, res, half) = _textures(
        scene, engine)
    assert got == ("device" if engine == "device" else "native")
    n = len(idx)
    want = jtex.generate_texture_map(
        poses, idx, np.arange(n), grid, lambda ids: (disp[ids], rgb[ids]),
        _map(jc, res, half), jc.CameraConfig(), batch_size=2,
        projector="native")
    np.testing.assert_array_equal(tex.numpy(), want)
    spec = _np_texture_reference(poses, idx, disp, rgb, grid,
                                 _map(jc, res, half), jc.CameraConfig())
    np.testing.assert_allclose(tex.numpy(), spec, atol=1e-6)


@pytest.mark.parametrize("group", [1, 3, 8])
def test_grouped_uploads_equal(group):
    """ops_group batches of paint ops in one upload: the same texture for
    every grouping (3: an uneven last flush; 8: all in one), equal to the
    device engine's on test_native_projector_grouped_uploads_equal's
    scene."""
    got, engine, _ = _textures("grouped", "native", ops_group=group)
    want, _, _ = _textures("grouped", "device")
    assert engine == "native"
    assert torch.equal(got, want)


def test_auto_takes_device_for_float_disparity_and_native_raises():
    disp, rgb, poses, idx, rng, res, half = _projector_scene("spec")
    m = _map(tc, res, half)
    grid = np.zeros((m.width, m.height), np.uint8)
    n = len(idx)

    def floats(ids):
        return disp[ids].astype(np.float32), rgb[ids]

    args = (poses, idx, np.arange(n), grid, floats, m, tc.CameraConfig())
    tex_a, engine = ttex.generate_texture_map(*args, projector="auto",
                                              device="cpu")
    assert engine == "device"
    tex_n, _ = ttex.generate_texture_map(
        poses, idx, np.arange(n), grid, lambda ids: (disp[ids], rgb[ids]), m,
        tc.CameraConfig(), projector="native", device="cpu")
    assert torch.equal(tex_a, tex_n)
    with pytest.raises(RuntimeError, match="integer"):
        ttex.generate_texture_map(*args, projector="native", device="cpu")


def _brute(tgt, q):
    d2 = ((q[:, None, :].astype(np.float64)
           - tgt[None].astype(np.float64)) ** 2).sum(-1)
    return d2.argmin(1).astype(np.int32), d2.min(1).astype(np.float32)


@pytest.mark.parametrize("dims", [2, 3])
def test_kdtree_equals_bruteforce(dims):
    rng = np.random.default_rng(dims)
    tgt = rng.normal(0, 5.0, (700, dims)).astype(np.float32)
    q = rng.normal(0, 5.0, (300, dims)).astype(np.float32)
    idx, d2 = native.kdtree_query(tgt, q)
    want_idx, want_d2 = _brute(tgt, q)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(d2, want_d2)


def test_kdtree_ties_take_the_lowest_index():
    tgt = np.array([[1, 0], [0, 1], [-1, 0], [0, -1], [1, 0]], np.float32)
    idx, d2 = native.kdtree_query(tgt, np.zeros((1, 2), np.float32))
    assert idx.tolist() == [0] and d2.tolist() == [1.0]
    with pytest.raises(ValueError, match="shape mismatch"):
        native.kdtree_query(tgt, np.zeros((1, 3), np.float32))


def _clustered(rng, n):
    centers = rng.uniform(-5, 5, (4, 2))
    pts = centers[rng.integers(0, 4, n)] + rng.normal(0, 0.1, (n, 2))
    pts[: n // 10] = rng.uniform(-8, 8, (n // 10, 2))
    return pts.astype(np.float32)


@pytest.mark.parametrize("eps,min_samples", [(0.2, 5), (0.1, 3)])
def test_dbscan_equals_sklearn_and_jax(jax_native, eps, min_samples):
    from sklearn.cluster import DBSCAN

    pts = _clustered(np.random.default_rng(int(eps * 100)), 600)
    got = native.dbscan(pts, eps, min_samples)
    np.testing.assert_array_equal(got, jax_native.dbscan(pts, eps,
                                                         min_samples))
    want = DBSCAN(eps=eps, min_samples=min_samples).fit(pts).labels_
    np.testing.assert_array_equal(got == -1, want == -1)
    assert (got >= 0).sum() > 100


_BUILD = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from lidar_slam_tpu_torch.utils import native
native.BUILD_DIR = Path(sys.argv[2])
lib = native.host_library()
assert native.png_available()
print(native.library_path("slamhost").name)
"""


def test_concurrent_builds_each_load(tmp_path):
    """Four processes building both libraries into one empty directory at
    once: each ends with a whole library it loads, and no temporary
    directory is left behind."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, ROOT,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        [names.pop(), native.library_path("slampng").name])


def test_failed_projector_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output: the auto
    engine never drops to the device quietly."""
    (tmp_path / "slamhost.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("slamhost")
