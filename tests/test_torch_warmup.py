"""The port's 3-D ICP warm-up (models/warmup.py), its 3-D Kabsch, chunked
NN, non-planar ICP and voxel downsampling against the JAX package's, on
the same seeded numpy float32 inputs, on the CPU.

The JAX side is fed float32 arrays (the test harness turns on x64, so
float64 input would run JAX in float64). Tolerances, each measured first:
the 3-D Kabsch within 1e-5 of JAX's (LAPACK's singular-vector signs may
differ; R does not); one non-planar ICP iteration from JAX's own T with
the same correspondences and T within 1e-5; the whole sweep with the same
best seed, every seed's iteration count equal (no seed's count differed
over the cases below) and every seed's T within 2e-6 and error within
1e-6 of JAX's (measured 5.4e-7 and 9.7e-7).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.models import warmup as jw
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import kabsch as jkabsch
from lidar_slam_tpu.ops import nn as jnn
from lidar_slam_tpu.ops import voxel as jvoxel

from lidar_slam_tpu_torch.models import warmup as tw
from lidar_slam_tpu_torch.ops import icp as ticp
from lidar_slam_tpu_torch.ops import kabsch as tkabsch
from lidar_slam_tpu_torch.ops import nn as tnn
from lidar_slam_tpu_torch.ops import voxel as tvoxel

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32
SWEEP_T_TOL, SWEEP_ERR_TOL = 2e-6, 1e-6


def _large_yaw_clouds():
    """test_correlation_voxel_warmup.py::test_warmup_recovers_large_yaw's
    clouds: a 400-point ellipsoid turned 150 degrees."""
    rng = np.random.default_rng(3)
    src = rng.normal(0, 0.1, (400, 3)) * np.array([1.0, 0.6, 0.3])
    yaw = np.radians(150.0)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    tgt = (src @ R.T + np.array([0.3, -0.2, 0.1])
           + rng.normal(0, 0.002, src.shape))
    return src.astype(F32), tgt.astype(F32), R


def _clouds(case):
    """(source, target, seed batch) of a sweep case, float32."""
    if case == "large_yaw":
        src, tgt, _ = _large_yaw_clouds()
        return src, tgt, 12
    n, idx, seed = {"synth600": (600, 0, 3), "synth800_0": (800, 0, 0),
                    "synth800_1": (800, 1, 0), "synth800_3": (800, 3, 0)}[case]
    model = tw.synthetic_model(n, seed=seed)
    return (model.astype(F32), tw.synthetic_pc(model, idx, seed).astype(F32),
            8)


def _jax_sweep(src, tgt, n_seeds, seed_batch):
    """JAX's run_icp_batch over the yaw seeds as best_icp_alignment runs
    it, keeping the iteration counts: (T, errors, iterations)."""
    seeds = jw.yaw_seed_transforms(src, tgt, n_seeds).astype(F32)
    out = []
    for s in range(0, n_seeds, seed_batch):
        b = min(seed_batch, n_seeds - s)
        r = jicp.run_icp_batch(
            jnp.tile(jnp.asarray(src)[None], (b, 1, 1)),
            jnp.tile(jnp.asarray(tgt)[None], (b, 1, 1)),
            jnp.ones((b, src.shape[0]), bool),
            jnp.ones((b, tgt.shape[0]), bool), jnp.asarray(seeds[s:s + b]),
            epsilon=0.001, normalize_error=True, planar=False)
        out.append([np.asarray(a) for a in (r.T, r.error, r.iters)])
    return [np.concatenate(a) for a in zip(*out)]


@pytest.mark.parametrize("shape,weights", [
    ((64, 3), "none"), ((5, 200, 3), "bool"), ((2, 3, 50, 3), "float"),
    ((7, 120, 3), "reflect")])
def test_kabsch_3d_equals_jax(shape, weights):
    """The 3-D weighted Kabsch within 1e-5 of JAX's on random clouds, a
    proper rotation; "reflect" mirrors the target, where the det guard
    must act."""
    rng = np.random.default_rng(len(shape) * 10 + shape[-2])
    src = rng.normal(0, 1.0, shape).astype(F32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    tgt = (src @ R.T + rng.normal(0, 0.05, shape)).astype(F32)
    if weights == "reflect":
        tgt[..., 2] *= -1
    w = {"none": None, "bool": rng.random(shape[:-1]) > 0.3,
         "float": rng.random(shape[:-1]).astype(F32),
         "reflect": None}[weights]
    want = np.asarray(jkabsch.kabsch(jnp.asarray(src), jnp.asarray(tgt),
                                     None if w is None else jnp.asarray(w)))
    got = tkabsch.kabsch(torch.from_numpy(src), torch.from_numpy(tgt),
                         None if w is None else torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got[..., :3, :3]), 1.0,
                               atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", ["synth600", "large_yaw"])
@pytest.mark.parametrize("start", ["seed", "one_iteration"])
def test_icp_one_iteration_nonplanar_from_jax_transform(case, start):
    """One planar=False ICP iteration of 8 seeds from JAX's own T (the yaw
    seeds, or JAX's T after one iteration): the same correspondences, the
    next T within 1e-5 and the normalized error within 1e-6 relative."""
    src, tgt, _ = _clouds(case)
    T0 = jw.yaw_seed_transforms(src, tgt, 24)[::3].astype(F32)
    B = T0.shape[0]
    js, jt = (jnp.tile(jnp.asarray(a)[None], (B, 1, 1)) for a in (src, tgt))
    jsm, jtm = jnp.ones(js.shape[:2], bool), jnp.ones(jt.shape[:2], bool)
    if start == "one_iteration":
        T0 = np.asarray(jicp.icp_iteration(js, jt, jsm, jtm, jnp.asarray(T0),
                                           True, planar=False)[0])
    Tj, idxj, errj = (np.asarray(a) for a in jicp.icp_iteration(
        js, jt, jsm, jtm, jnp.asarray(T0), True, planar=False))
    T, idx, err = ticp.icp_iteration(
        _t(np.asarray(js)), _t(np.asarray(jt)), _t(np.asarray(jsm)),
        _t(np.asarray(jtm)), _t(T0), True, planar=False)
    np.testing.assert_array_equal(idx.numpy(), idxj)
    np.testing.assert_allclose(T.numpy(), Tj, atol=1e-5)
    np.testing.assert_allclose(err.numpy(), errj, rtol=1e-6)


@pytest.mark.parametrize("case", ["large_yaw", "synth600", "synth800_0",
                                  "synth800_1", "synth800_3"])
def test_best_icp_alignment_equals_jax(case):
    """The 24-seed sweep against JAX's: the same best seed and iteration
    counts, each seed's T and error within the measured bounds, and the
    best (T, error) JAX's best_icp_alignment returns."""
    src, tgt, sb = _clouds(case)
    Tj, ej, ij = _jax_sweep(src, tgt, 24, sb)
    T, err, errs, iters = tw.best_icp_alignment(src, tgt, seed_batch=sb,
                                                device="cpu")
    assert int(np.argmin(errs)) == int(np.argmin(ej))
    np.testing.assert_array_equal(iters, ij)
    np.testing.assert_allclose(errs, ej, atol=SWEEP_ERR_TOL, rtol=0)
    bj, e_best, _ = jw.best_icp_alignment(src, tgt, seed_batch=sb)
    np.testing.assert_allclose(T, bj, atol=SWEEP_T_TOL)
    np.testing.assert_allclose(err, e_best, atol=SWEEP_ERR_TOL, rtol=0)
    assert errs.dtype == np.float32 and T.shape == (4, 4)


def test_warmup_recovers_large_yaw():
    """The JAX test's claims on the port: the sweep recovers a 150-degree
    turn that most seeds miss."""
    src, tgt, R = _large_yaw_clouds()
    best_T, best_err, errs, _ = tw.best_icp_alignment(
        src, tgt, n_seeds=24, seed_batch=12, device="cpu")
    np.testing.assert_allclose(best_T[:3, :3], R, atol=0.05)
    assert best_err < 0.002 and errs.shape == (24,)
    assert (errs > best_err * 10).sum() > 5


def test_warmup_stopping_rule_misses_like_jax():
    """synthetic_pc(model, 1) of an 800-point model: the reference's stop
    (|delta normalized error| < 1e-4) ends every seed after a few
    iterations, and the best T is still more than 0.05 from the applied
    rotation, in both packages alike (chip_smoke.py [16] (a) gates cloud 1
    against the CPU run for that reason)."""
    model = tw.synthetic_model(800)
    tgt = tw.synthetic_pc(model, 1).astype(F32)
    G = tw.synthetic_pose(model, 1)
    T, _, _, iters = tw.best_icp_alignment(model.astype(F32), tgt,
                                           device="cpu")
    Tj, _, _ = jw.best_icp_alignment(model.astype(F32), tgt)
    np.testing.assert_allclose(T, Tj, atol=SWEEP_T_TOL)
    assert 0.05 < np.abs(T[:3, :3] - G[:3, :3]).max() < 0.1
    assert iters.max() <= 6


def test_synthetic_pose_is_the_applied_transform():
    """synthetic_pc's cloud is synthetic_pose applied to the kept model
    points plus N(0, 0.003) noise, drawn as the JAX package draws it."""
    model = tw.synthetic_model(500, seed=2)
    for idx in range(3):
        pc = tw.synthetic_pc(model, idx, seed=2)
        np.testing.assert_array_equal(pc, jw.synthetic_pc(model, idx, seed=2))
        T = tw.synthetic_pose(model, idx, seed=2)
        keep = np.random.default_rng(2 + 100 * (idx + 1))
        keep.uniform(-np.pi, np.pi)
        kept = model[keep.random(500) > 0.3]
        resid = pc - (kept @ T[:3, :3].T + T[:3, 3])
        assert np.abs(resid).max() < 0.003 * 6
    np.testing.assert_array_equal(tw.synthetic_model(300, seed=4),
                                  jw.synthetic_model(300, seed=4))
    np.testing.assert_array_equal(
        tw.yaw_seed_transforms(model, pc, 24),
        jw.yaw_seed_transforms(model, pc, 24))


def test_warmup_downsample_trigger():
    """test_warmup_downsample_trigger's 25,000-point cloud: both clouds go
    through voxel_downsample (above downsample_above), and the result
    equals JAX's."""
    rng = np.random.default_rng(4)
    src = rng.normal(0, 0.1, (25000, 3)).astype(F32)
    tgt = src + np.array([0.05, 0.0, 0.0], F32)
    kw = dict(n_seeds=2, downsample_above=20000, voxel_size=0.05,
              seed_batch=2)
    best_T, best_err, _, _ = tw.best_icp_alignment(src, tgt, device="cpu",
                                                   **kw)
    assert np.isfinite(best_err)
    np.testing.assert_allclose(best_T[:3, 3], [0.05, 0, 0], atol=0.02)
    Tj, ej, _ = jw.best_icp_alignment(src, tgt, **kw)
    np.testing.assert_allclose(best_T, Tj, atol=SWEEP_T_TOL)
    np.testing.assert_allclose(best_err, ej, atol=SWEEP_ERR_TOL, rtol=0)


@pytest.mark.parametrize("n_src,n_tgt,seed_batch", [
    (3000, 3000, 8), (10000, 10000, 8), (19000, 20000, 4), (500, 700, 12),
    (20000, 20000, 8)])
def test_memory_guard_seed_batch_rule(monkeypatch, n_src, n_tgt,
                                      seed_batch):
    """The seed batches and the NN mode each package's best_icp_alignment
    hands its ICP equal JAX's (batch shrunk to fit 1.5 GB of (B, N, M)
    float32 distances; chunked sources when one seed exceeds it), with
    the ICP replaced by a recorder."""
    calls = {"jax": [], "port": []}

    def jax_rec(src, tgt, sm, tm, T0, **kw):
        calls["jax"].append((src.shape[0], kw["nn_backend"] == "chunked"))
        return jicp.IcpResult(T=T0, error=jnp.zeros(src.shape[0]),
                              iters=None, correspondences=None)

    def port_rec(src, tgt, sm, tm, T0, **kw):
        calls["port"].append((src.shape[0], kw["nn_chunk"] is not None))
        assert not kw["planar"]
        z = torch.zeros(src.shape[0])
        return ticp.IcpResult(T=T0, error=z, iters=z, correspondences=None)

    monkeypatch.setattr(jicp, "run_icp_batch", jax_rec)
    monkeypatch.setattr(ticp, "run_icp_batch", port_rec)
    src = np.zeros((n_src, 3), F32)
    tgt = np.ones((n_tgt, 3), F32)
    kw = dict(n_seeds=24, seed_batch=seed_batch, downsample_above=10**9)
    jw.best_icp_alignment(src, tgt, **kw)
    tw.best_icp_alignment(src, tgt, device="cpu", **kw)
    assert calls["port"] == calls["jax"] and calls["jax"]


def test_chunked_nn_path_equals_plain(monkeypatch):
    """With the budget cut so one seed exceeds it, the sweep searches the
    sources in chunks and returns exactly the unchunked result."""
    src, tgt, _ = _clouds("synth600")
    want = tw.best_icp_alignment(src, tgt, n_seeds=8, device="cpu")
    monkeypatch.setattr(tw, "NN_BUDGET_BYTES", 1e5)
    monkeypatch.setattr(tw, "NN_CHUNK", 128)
    assert tw.seed_batch_rule(src.shape[0], tgt.shape[0], 8) == (1, 128)
    got = tw.best_icp_alignment(src, tgt, n_seeds=8, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [1, 128, 499, 500, 2048])
def test_chunked_nn_equals_plain(chunk):
    """nearest_neighbors_chunked equal to nearest_neighbors and to JAX's
    chunked search (test_chunked_nn_matches_plain's inputs)."""
    rng = np.random.default_rng(5)
    src = rng.normal(size=(2, 500, 3)).astype(F32)
    tgt = rng.normal(size=(2, 300, 3)).astype(F32)
    mask = rng.random((2, 300)) > 0.3
    got = tnn.nearest_neighbors_chunked(_t(src), _t(tgt), _t(mask),
                                        src_chunk=chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), tnn.nearest_neighbors(_t(src), _t(tgt), _t(mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnn.nearest_neighbors_chunked(src, tgt, mask, src_chunk=chunk)))


def test_nearest_neighbor_dists_equal_jax():
    rng = np.random.default_rng(6)
    src = rng.normal(size=(3, 200, 3)).astype(F32)
    tgt = rng.normal(size=(3, 150, 3)).astype(F32)
    mask = rng.random((3, 150)) > 0.2
    idx, d2 = tnn.nearest_neighbor_dists(_t(src), _t(tgt), _t(mask))
    idx_j, d2_j = jnn.nearest_neighbor_dists(src, tgt, mask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("voxel", [0.05, 0.5])
def test_voxel_downsample_bit_equal(dtype, voxel):
    rng = np.random.default_rng(1)
    pc = rng.normal(0, 1.0, (2000, 3)).astype(dtype)
    got = tvoxel.voxel_downsample(pc, voxel)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, jvoxel.voxel_downsample(pc, voxel))


@pytest.mark.parametrize("max_voxels", [256, 40])
def test_voxel_downsample_masked_equals_host_and_jax(max_voxels):
    """The fixed-shape voxel means: as a set, the host routine's voxels
    (means within 1e-6) when max_voxels holds them all; in either case
    exactly JAX's voxel_downsample_masked in linear-id order, with its
    drop rule past max_voxels."""
    rng = np.random.default_rng(2)
    pc = rng.normal(0, 1.0, (400, 3))
    mask = rng.random(400) > 0.3
    got, valid = tvoxel.voxel_downsample_masked(_t(pc), _t(mask), 0.5,
                                                max_voxels)
    want, valid_j = jvoxel.voxel_downsample_masked(
        jnp.asarray(pc), jnp.asarray(mask), 0.5, max_voxels=max_voxels)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    host = tvoxel.voxel_downsample(pc[mask], 0.5)
    if max_voxels >= len(host):
        g = got.numpy()[valid.numpy()]
        assert len(g) == len(host)
        np.testing.assert_allclose(g[np.lexsort(g.T)],
                                   host[np.lexsort(host.T)], atol=1e-6)
    else:
        assert int(valid.sum()) == max_voxels


def test_run_icp_single_pair_equals_jax():
    """run_icp on one 2-D pair (lifted to z = 0, the planar fit) and one
    3-D pair (the SVD fit) against JAX's run_icp."""
    rng = np.random.default_rng(9)
    a = rng.normal(0, 2.0, (300, 2)).astype(F32)
    th = 0.1
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], F32)
    b = (a @ R.T + np.array([0.2, -0.1], F32)).astype(F32)
    z = rng.normal(0, 1.0, (300, 1)).astype(F32)
    for p, q in [(a, b), (np.c_[a, z], np.c_[b, z + F32(0.05)])]:
        got = ticp.run_icp(_t(p), _t(q))
        want = jicp.run_icp(p, q)
        assert got.T.shape == (4, 4) and got.correspondences.shape == (300,)
        assert int(got.iters) == int(want.iters)
        np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T),
                                   atol=1e-5)
        np.testing.assert_array_equal(got.correspondences.numpy(),
                                      np.asarray(want.correspondences))


def test_point_to_line_is_planar_only():
    z = torch.zeros((1, 4, 3))
    m = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="planar only"):
        ticp.run_icp_batch(z, z, m, m, torch.eye(4)[None],
                           metric="point_to_line", planar=False)


def test_export_ply_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(7, 3))
    b = rng.normal(size=(4, 3))
    p = tmp_path / "out.ply"
    tw.export_ply(str(p), [a, b])
    jw.export_ply(str(tmp_path / "jax.ply"), [a, b])
    assert p.read_bytes() == (tmp_path / "jax.ply").read_bytes()
    lines = p.read_text().splitlines()
    n_hdr = lines.index("end_header") + 1
    assert "element vertex 11" in lines[:n_hdr]
    pts = np.array([[float(v) for v in ln.split()[:3]]
                    for ln in lines[n_hdr:]])
    np.testing.assert_allclose(pts, np.concatenate([a, b]), atol=1e-5)
    with pytest.raises(ValueError, match="colors"):
        tw.export_ply(str(p), [a, b], colors=[(1, 2, 3)])


def test_view_interactive_falls_back_without_open3d():
    clouds = [np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32)]
    assert tw.view_interactive(clouds) is False


def test_best_icp_alignment_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.best_icp_alignment(np.zeros((4, 3)), np.zeros((4, 3)))


def _best_errors(out: str) -> list:
    lines = out.splitlines()
    return lines[lines.index("Best errors:"):]


def test_warmup_cli_equals_jax_cli(tmp_path):
    """python -m lidar_slam_tpu_torch.warmup_icp --synthetic --device cpu
    prints the "Best errors" block that warmup_icp.py prints (JAX on the
    CPU, float32 as its CLI runs), on one cloud and 8 seeds; both write
    images/drill_0.ply with --export_ply."""
    args = ["--synthetic", "--num_pc", "1", "--n_seeds", "8",
            "--export_ply"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = subprocess.run(
        [sys.executable, "-m", "lidar_slam_tpu_torch.warmup_icp", *args,
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=tmp_path / "port", timeout=600)
    assert port.returncode == 0, port.stderr
    env["JAX_PLATFORMS"] = "cpu"
    jax_run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "warmup_icp.py"), *args],
        capture_output=True, text=True, env=env, cwd=tmp_path / "jax",
        timeout=600)
    assert jax_run.returncode == 0, jax_run.stderr
    assert _best_errors(port.stdout) == _best_errors(jax_run.stdout)
    assert len(_best_errors(port.stdout)) == 2
    assert (tmp_path / "port" / "images" / "drill_0.ply").exists()
