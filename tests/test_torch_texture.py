"""The port's texture mapping (models/texture.py) against the JAX package's
(lidar_slam_tpu/models/texture.py, its "device" projector) and the numpy
spec model of tests/test_texture.py, on the same seeded numpy frames, on
the CPU.

Contract: the cells, the colors of the valid points and the composed
texture equal to JAX's bit for bit on tests/test_texture.py's scenes; the
last frame wins; the depth and registration formulas as the reference
writes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import texture as jtex

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import texture as ttex
from tests.test_texture import _np_texture_reference, _synthetic_frames

torch.set_num_threads(1)


def _map(C, res=0.1, half=8):
    return C.MapConfig(resolution=res, world_max_x=half, world_min_x=-half,
                       world_max_y=half, world_min_y=-half)


def _scene(name):
    """tests/test_texture.py's scenes: (poses, rgb_pose, disp, rgb, grid,
    res, batch_size)."""
    if name == "spec":  # test_texture_matches_reference_spec
        rng = np.random.default_rng(0)
        disp, rgb = _synthetic_frames(rng, 3)
        poses = rng.normal(0, 1.0, (10, 3))
        grid = rng.integers(0, 2, (161, 161)).astype(np.uint8)
        return poses, np.array([1, 4, 7]), disp, rgb, grid, 0.1, 2
    if name == "last_frame":  # test_texture_last_frame_wins
        rng = np.random.default_rng(1)
        disp, rgb = _synthetic_frames(rng, 2)
        disp[1] = disp[0]  # same geometry
        return (np.zeros((2, 3)), np.array([0, 1]), disp, rgb,
                np.zeros((161, 161), np.uint8), 0.1, 1)
    # test_generate_texture_packed_vs_float_loader: raw uint16 disparity
    rng = np.random.default_rng(12)
    disp = rng.integers(300, 900, (7, 24, 32)).astype(np.uint16)
    rgb = rng.integers(0, 255, (7, 24, 32, 3)).astype(np.uint8)
    poses = rng.normal(0, 0.5, (7, 3)).astype(np.float32)
    grid = rng.integers(0, 2, (81, 81)).astype(np.uint8)
    return poses, np.arange(7), disp, rgb, grid, 0.2, 3


SCENES = ["spec", "last_frame", "uint16"]


@pytest.mark.parametrize("scene", SCENES)
def test_texture_equals_jax_device_engine(scene):
    """The composed texture equal to JAX's generate_texture_map(projector=
    "device") bit for bit, and to the numpy spec model within 1e-6."""
    poses, rgb_pose, disp, rgb, grid, res, bs = _scene(scene)
    n = len(rgb_pose)

    def loader(ids):
        return disp[ids], rgb[ids]

    want = jtex.generate_texture_map(
        poses, rgb_pose, np.arange(n), grid, loader, _map(jc, res),
        jc.CameraConfig(), batch_size=bs, projector="device")
    got, engine = ttex.generate_texture_map(
        poses, rgb_pose, np.arange(n), grid, loader, _map(tc, res),
        tc.CameraConfig(), batch_size=bs, device="cpu")
    assert engine == "device"
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    spec = _np_texture_reference(poses, rgb_pose, disp, rgb, grid,
                                 _map(jc, res), jc.CameraConfig())
    np.testing.assert_allclose(got.numpy(), spec, atol=1e-6)
    painted = (got.numpy() != grid[..., None] / np.float32(255.0)).any(-1)
    assert painted.sum() >= 10
    if scene == "last_frame":  # frame 1 repaints every cell of frame 0
        alone, _ = ttex.generate_texture_map(
            poses, rgb_pose[1:], np.arange(1), grid,
            lambda ids: (disp[ids + 1], rgb[ids + 1]), _map(tc, res),
            tc.CameraConfig(), device="cpu")
        assert torch.equal(got, alone)


@pytest.mark.parametrize("scene", SCENES)
def test_frames_to_cells_equal_jax(scene):
    """Each batch's cells and valid mask equal to JAX's, and the colors of
    its valid points (an invalid point's color is never painted)."""
    poses, rgb_pose, disp, rgb, _, res, _ = _scene(scene)
    pb = np.asarray(poses[rgb_pose], np.float32)
    lin_j, col_j, ok_j = (np.asarray(a) for a in jtex.frames_to_cells(
        jnp.asarray(disp), jnp.asarray(rgb), jnp.asarray(pb), _map(jc, res),
        jc.CameraConfig()))
    t_disp = torch.from_numpy(disp.view(np.int16) if disp.dtype == np.uint16
                              else disp)
    lin, col, ok = ttex.frames_to_cells(t_disp, torch.from_numpy(rgb),
                                        torch.from_numpy(pb), _map(tc, res),
                                        tc.CameraConfig())
    assert lin.dtype == col.dtype == torch.int32
    np.testing.assert_array_equal(lin.numpy(), lin_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    np.testing.assert_array_equal(col.numpy()[ok_j], col_j[ok_j])
    assert 0 < ok_j.sum() < ok_j.size


def test_paint_cells_last_writer_wins():
    """Three batches writing cells 0-5: the largest sequence number, the
    last write, takes each cell, in a scatter of any order; -1 paints
    nothing."""
    winner = torch.full((8,), -1, dtype=torch.int32)
    color = torch.zeros(8, dtype=torch.int32)
    batches = [([0, 1, 2, 1], [10, 11, 12, 13]), ([2, -1, 3, 3], [20, 21, 22, 23]),
               ([5, 0, -1, 5], [30, 31, 32, 33])]
    base = 0
    for lin, col in batches:
        winner, color = ttex.paint_cells(
            winner, color, torch.tensor(lin, dtype=torch.int32),
            torch.tensor(col, dtype=torch.int32), base)
        base += len(lin)
    assert winner.tolist() == [9, 3, 4, 7, -1, 11, -1, -1]
    assert color.tolist() == [31, 13, 20, 23, 0, 33, 0, 0]
    # the same ops as one padded paint-op buffer
    cells = np.concatenate([b[0] for b in batches]).astype(np.int32)
    cols = np.concatenate([b[1] for b in batches]).astype(np.int32)
    w2, c2 = ttex.paint_ops(torch.full((8,), -1, dtype=torch.int32),
                            torch.zeros(8, dtype=torch.int32),
                            torch.from_numpy(ttex._pad_paint_ops(
                                cells, cols, min_pad=4)), 0)
    assert torch.equal(w2, winner) and torch.equal(c2, color)


def test_pad_paint_ops_buckets():
    c = np.arange(5, dtype=np.int32)
    ops = ttex._pad_paint_ops(c, c, min_pad=4)
    assert ops.shape == (2, 8)
    np.testing.assert_array_equal(ops[0, :5], c)
    assert (ops[0, 5:] == -1).all()
    assert ttex._pad_paint_ops(np.array([], np.int32), np.array([], np.int32),
                               min_pad=4).shape == (2, 4)
    np.testing.assert_array_equal(
        ttex._pad_paint_ops(c, c, min_pad=4, multiple_of=3),
        jtex._pad_paint_ops(c, c, min_pad=4, multiple_of=3))


def test_depth_and_registration_formulas():
    """The reference's formulas; one float32 rounding an operation in the
    reference's order (so the card and the CPU agree), bit for bit; and
    JAX's jitted values within a few ULPs: XLA on the CPU fuses a * x + b
    into one fused multiply-add (up to 6 ULPs of depth where dd cancels,
    6e-5 pixels of registration; the reference truncates to whole pixels)."""
    cam = tc.CameraConfig()
    depth = ttex.get_depth_image(torch.tensor([600.0]), cam)
    np.testing.assert_allclose(depth.numpy(), 1.03 / (-0.00304 * 600 + 3.31),
                               rtol=1e-6)
    ri, rj = ttex.get_rgbi_rgbj(torch.tensor([5.0]), torch.tensor([7.0]),
                                torch.tensor([2.0]), cam)
    np.testing.assert_allclose(ri.numpy(),
                               (526.37 * 5 + 19276 - 7877.07 * 2) / 585.051,
                               rtol=1e-6)
    np.testing.assert_allclose(rj.numpy(), (526.37 * 7 + 16662) / 585.051,
                               rtol=1e-6)
    rng = np.random.default_rng(8)
    d = rng.uniform(300, 1000, 4096).astype(np.float32)
    i, j = (rng.integers(0, 640, 4096).astype(np.float32) for _ in range(2))
    f = np.float32
    dep = ttex.get_depth_image(torch.from_numpy(d), cam).numpy()
    np.testing.assert_array_equal(dep, f(1.03) / (f(-0.00304) * d + f(3.31)))
    inv = f(1) / f(585.051)
    ri, rj = (a.numpy() for a in ttex.get_rgbi_rgbj(
        *map(torch.from_numpy, (i, j, dep)), cam))
    np.testing.assert_array_equal(
        ri, (f(526.37) * i + f(19276.0) - f(7877.07) * dep) * inv)
    np.testing.assert_array_equal(rj, (f(526.37) * j + f(16662.0)) * inv)
    # JAX, jitted as frames_to_cells runs it
    jd = np.asarray(jax.jit(lambda x: jtex.get_depth_image(
        x, jc.CameraConfig()))(d))
    np.testing.assert_allclose(dep, jd, rtol=1e-6)
    for a, b in zip((ri, rj), jax.jit(lambda *a: jtex.get_rgbi_rgbj(
            *a, jc.CameraConfig()))(i, j, dep)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_camera_matrices_equal_jax():
    for a, b in zip(ttex.camera_matrices(tc.CameraConfig()),
                    jtex.camera_matrices(jc.CameraConfig())):
        np.testing.assert_array_equal(a, b)


def test_raw_uint16_disparity_widens_exactly():
    """Raw disparity above 32,767 (negative as int16 bits) gives the same
    cells as the float32 values."""
    rng = np.random.default_rng(4)
    disp = rng.integers(300, 65535, (2, 24, 32)).astype(np.uint16)
    disp[0, :12] = rng.integers(300, 900, (12, 32))
    rgb = rng.integers(0, 255, (2, 24, 32, 3)).astype(np.uint8)
    pb = torch.zeros((2, 3))
    args = (torch.from_numpy(rgb), pb, _map(tc), tc.CameraConfig())
    raw = ttex.frames_to_cells(torch.from_numpy(disp.view(np.int16)), *args)
    flt = ttex.frames_to_cells(torch.from_numpy(disp.astype(np.float32)),
                               *args)
    for a, b in zip(raw, flt):
        assert torch.equal(a, b)
    assert raw[2].any()


def test_disk_frame_loader_reads_the_reference_layout(tmp_path,
                                                      monkeypatch):
    from lidar_slam_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(6)
    disp = rng.integers(0, 65535, (3, 6, 8)).astype(np.uint16)
    rgb = rng.integers(0, 255, (2, 6, 8, 3)).astype(np.uint8)
    for k in range(3):
        write_png(str(tmp_path / "dataRGBD" / "Disparity20"
                      / f"disparity20_{k}.png"), disp[k])
    for i in range(2):
        write_png(str(tmp_path / "dataRGBD" / "RGB20" / f"rgb20_{i + 1}.png"),
                  rgb[i])
    monkeypatch.chdir(tmp_path)
    d, r = ttex.disk_frame_loader(20, np.array([2, 0]))(np.array([0, 1]))
    assert d.dtype == np.uint16 and r.dtype == np.uint8
    np.testing.assert_array_equal(d, disp[[2, 0]])
    np.testing.assert_array_equal(r, rgb)


def test_unknown_projector_raises():
    with pytest.raises(ValueError, match="unknown projector"):
        ttex.generate_texture_map(np.zeros((1, 3)), np.zeros(1, int),
                                  np.zeros(1, int), np.zeros((4, 4)),
                                  None, projector="host", device="cpu")
