"""Parity of the port's SE(2), scan, odometry, Kabsch, NN and ICP ops with
the JAX package on the same numpy inputs.

The JAX side runs in float64 (the test harness enables x64) or, for the
float32 cases, under jax.enable_x64(False), so both packages compute in the
dtype named by the test. Tolerances: float64 1e-9; float32 1e-6 for
closed-form ops, 1e-5 for ICP transforms (iterated, so rounding compounds).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_slam_tpu.config import LidarConfig
from lidar_slam_tpu.models import odometry as j_odo
from lidar_slam_tpu.models import scan_matching as jsm
from lidar_slam_tpu.ops import icp as jicp
from lidar_slam_tpu.ops import kabsch as jkabsch
from lidar_slam_tpu.ops import nn as jnn
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.ops.pallas_nn import nearest_neighbors_pallas
from lidar_slam_tpu.utils import io as jio
from lidar_slam_tpu.utils import se2 as jse2

from lidar_slam_tpu_torch.kernels.nn import nn_argmin
from lidar_slam_tpu_torch.models import odometry as t_odo
from lidar_slam_tpu_torch.models import scan_matching as tsm
from lidar_slam_tpu_torch.ops import icp as ticp
from lidar_slam_tpu_torch.ops import kabsch as tkabsch
from lidar_slam_tpu_torch.ops import nn as tnn
from lidar_slam_tpu_torch.ops import scan as tscan
from lidar_slam_tpu_torch.utils import se2 as tse2

torch.set_num_threads(1)

DTYPES = {"f64": (np.float64, torch.float64, 1e-9),
          "f32": (np.float32, torch.float32, 1e-6)}


def _jax_dtype_ctx(np_dtype):
    """float32 JAX runs need x64 off, or numpy float32 inputs meet float64
    constants (linspace, eye) and promote."""
    return jax.enable_x64(np_dtype == np.float64)


def _cmp(got, want, tol):
    """Same shape and dtype; values within tol relative to the array's
    scale (max(1, max|want|)): the two frameworks' float32 sin/cos may
    differ by an ULP of the largest term, e.g. 2e-6 on a 30 m ray."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_se2_matches_jax(dt):
    npd, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    p1 = rng.normal(0, 2.0, (17, 3)).astype(npd)
    p2 = rng.normal(0, 2.0, (17, 3)).astype(npd)
    p2[:3, 2] = p1[:3, 2] + np.array([0.0, 1e-8, -3e-7], npd)  # tiny omega
    pts = rng.normal(0, 3.0, (17, 40, 2)).astype(npd)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    with _jax_dtype_ctx(npd):
        T1, T2 = jse2.T_from_pose(jnp.asarray(p1)), jse2.T_from_pose(jnp.asarray(p2))
        rel = jse2.get_relative_pose(jnp.asarray(p1), jnp.asarray(p2))
        want = {
            "T": T1, "pose": jse2.pose_from_T(T1), "inv": jse2.inverse_T(T1),
            "rel": rel, "T3": jse2.TSE3_from_TSE2(rel),
            "T2": jse2.TSE2_from_TSE3(jse2.TSE3_from_TSE2(rel)),
            "inv3": jse2.inverse_T(jse2.TSE3_from_TSE2(rel)),
            "pts": jse2.transform_points(jnp.asarray(pts), T1),
            "chain": jse2.compose_chain(rel[:-1] @ rel[1:] * 0 + rel[1:]),
            "wrap": jse2.wrap_angle(jnp.asarray(p1[:, 2] * 5)),
            "log": jse2.log_se2(rel),
            "exp": jse2.exp_se2(jnp.asarray(p2)),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
    tT1 = tse2.T_from_pose(t(p1))
    trel = tse2.get_relative_pose(t(p1), t(p2))
    got = {
        "T": tT1, "pose": tse2.pose_from_T(tT1), "inv": tse2.inverse_T(tT1),
        "rel": trel, "T3": tse2.TSE3_from_TSE2(trel),
        "T2": tse2.TSE2_from_TSE3(tse2.TSE3_from_TSE2(trel)),
        "inv3": tse2.inverse_T(tse2.TSE3_from_TSE2(trel)),
        "pts": tse2.transform_points(t(pts), tT1),
        "chain": tse2.compose_chain(t(want["rel"][1:])),
        "wrap": tse2.wrap_angle(t(p1[:, 2] * 5)),
        "log": tse2.log_se2(trel),
        "exp": tse2.exp_se2(t(p2)),
    }
    for k in want:
        # the chain compounds 16 products: allow their accumulated rounding
        _cmp(got[k], want[k], tol * (20 if k == "chain" else 1))
    with pytest.raises(ValueError):
        tse2.transform_points(t(pts), tse2.TSE3_from_TSE2(trel))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_scans_and_odometry_match_jax(dt):
    npd, tdt, tol = DTYPES[dt]
    d = jio.synthetic_dataset(n_steps=80, n_rays=181, seed=5)
    counts = d["encoder"]["counts"].astype(npd)
    gyro = d["imu"]["angular_velocity"].astype(npd)
    ranges = d["lidar"]["ranges"].astype(npd)
    cfg = LidarConfig(n_rays=181)
    with _jax_dtype_ctx(npd):
        jp, jm = jscan.scans_to_points(jnp.asarray(ranges), 0.1, 30.0, cfg)
        jpo, jrel = j_odo.poses_from_odometry(jnp.asarray(counts),
                                              jnp.asarray(gyro),
                                              return_relative_poses=True)
        jg = j_odo.max_step_gates(jnp.asarray(counts), jnp.asarray(gyro))
        jang = jscan.scan_angles(cfg, 181)
        jp, jm, jpo, jrel, jang = map(np.asarray, (jp, jm, jpo, jrel, jang))
        jg = [np.asarray(g) for g in jg]
    tp, tm = tscan.scans_to_points(torch.from_numpy(ranges), 0.1, 30.0, cfg)
    tpo, trel = t_odo.poses_from_odometry(torch.from_numpy(counts),
                                          torch.from_numpy(gyro),
                                          return_relative_poses=True)
    tg = t_odo.max_step_gates(torch.from_numpy(counts), torch.from_numpy(gyro))
    _cmp(tscan.scan_angles(cfg, 181, dtype=tdt), jang, tol)
    _cmp(tp, jp, tol)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert 0.9 < jm.mean() < 1.0  # dropouts exercise the mask
    _cmp(tpo, jpo, tol)
    _cmp(trel, jrel, tol)
    for g_t, g_j in zip(tg, jg):
        _cmp(g_t, g_j, tol * max(1.0, abs(float(g_j))))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kabsch_planar_matches_jax(dt):
    npd, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    B, N = 6, 50
    src = rng.normal(0, 2.0, (B, N, 2)).astype(npd)
    ang = rng.normal(0, 0.5, B)
    R = np.stack([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    tgt = (np.einsum("ijb,bnj->bni", R, src)
           + rng.normal(0, 0.3, (B, 1, 2))
           + rng.normal(0, 0.01, (B, N, 2))).astype(npd)
    w = (rng.random((B, N)) > 0.3).astype(npd)
    w[0] = 0.0  # no valid point: the centroid guard
    with _jax_dtype_ctx(npd):
        jT = np.asarray(jkabsch.kabsch_planar(jnp.asarray(src),
                                              jnp.asarray(tgt),
                                              jnp.asarray(w)))
        jT1 = np.asarray(jkabsch.kabsch_planar(jnp.asarray(src),
                                               jnp.asarray(tgt)))
        jc = np.asarray(jkabsch.masked_centroid(jnp.asarray(src),
                                                jnp.asarray(w)))
    s, t_ = torch.from_numpy(src), torch.from_numpy(tgt)
    _cmp(tkabsch.kabsch_planar(s, t_, torch.from_numpy(w)), jT, 10 * tol)
    _cmp(tkabsch.kabsch_planar(s, t_), jT1, 10 * tol)
    _cmp(tkabsch.masked_centroid(s, torch.from_numpy(w)), jc, tol)


# -- nearest neighbours: the plain version of the Hopper NN kernel ----------

# the Pallas packed-key argmin truncates distances to 13 mantissa bits
# (tests/test_pallas_nn.py); float32 einsums in two frameworks may round
# the cross term differently in the last bit
_PALLAS_REL = 4 * 2.0 ** -12
_F32_REL = 1e-5


def _assert_near_tie_only(src, tgt, got, want, rel_tol, mask=None):
    """Indices equal, except flips between targets whose true squared
    distances agree within rel_tol; every chosen target is valid."""
    flips = got != want
    if flips.any():
        d = lambda i: ((src - np.take_along_axis(tgt, i[..., None], -2)) ** 2
                       ).sum(-1)  # noqa: E731
        rel = np.abs(d(got) - d(want)) / np.maximum(d(want), 1e-12)
        assert rel[flips].max() <= rel_tol, rel[flips].max()
    if mask is not None:
        assert np.take_along_axis(mask, got, -1).all()


NN_CASES = {  # tests/test_pallas_nn.py shapes: (seed, B, N, M, D, masked)
    "basic": (0, 3, 200, 150, 3, False),
    "masked": (1, 2, 130, 257, 3, True),
    "2d": (2, 1, 64, 90, 2, False),
}


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_plain_nn_matches_jax_and_pallas(case):
    seed, B, N, M, D, masked = NN_CASES[case]
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(B, N, D)).astype(np.float32)
    tgt = rng.normal(size=(B, M, D)).astype(np.float32)
    mask = rng.random((B, M)) > 0.4 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    # float64: exact index equality with the JAX einsum formulation
    want64 = np.asarray(jnn.nearest_neighbors(
        jnp.asarray(src, jnp.float64), jnp.asarray(tgt, jnp.float64), jm))
    got64 = tnn.nearest_neighbors(torch.from_numpy(src).double(),
                                  torch.from_numpy(tgt).double(), tm)
    assert got64.dtype == torch.int32
    np.testing.assert_array_equal(got64.numpy(), want64)

    # float32: the JAX path and the Pallas kernel (interpret mode)
    got = tnn.nearest_neighbors(torch.from_numpy(src),
                                torch.from_numpy(tgt), tm).numpy()
    with jax.enable_x64(False):
        want = np.asarray(jnn.nearest_neighbors(jnp.asarray(src),
                                                jnp.asarray(tgt), jm))
        pal = np.asarray(nearest_neighbors_pallas(
            jnp.asarray(src), jnp.asarray(tgt), jm, interpret=True))
    _assert_near_tie_only(src, tgt, got, want, _F32_REL, mask)
    _assert_near_tie_only(src, tgt, got, pal, _PALLAS_REL, mask)

    # the wrapper on CPU tensors is the plain version plus the gather, and
    # never launches the kernel
    before = nn_argmin.launches
    idx, matched = nn_argmin(torch.from_numpy(src), torch.from_numpy(tgt), tm)
    assert nn_argmin.launches == before
    np.testing.assert_array_equal(idx.numpy(), got)
    np.testing.assert_array_equal(
        matched.numpy(), np.take_along_axis(tgt, got[..., None], -2))


def test_plain_nn_exact_tie_lowest_index():
    src = torch.tensor([[[0.5, 0.5, 0.0]]])
    dup = [0.5, 0.6, 0.0]
    tgt = torch.tensor([[[9, 9, 9], dup, [3, 3, 3], dup, dup]],
                       dtype=torch.float32)
    assert int(tnn.nearest_neighbors(src, tgt)[0, 0]) == 1
    # a masked-out lower duplicate is skipped for the next valid one
    mask = torch.tensor([[True, False, True, True, True]])
    assert int(tnn.nearest_neighbors(src, tgt, mask)[0, 0]) == 3
    idx, matched = nn_argmin(src, tgt, mask)
    assert int(idx[0, 0]) == 3 and torch.equal(matched[0, 0], tgt[0, 3])


# -- ICP --------------------------------------------------------------------

def _icp_pairs(seed, B, P, npd):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-3, 3, (B, P, 2))
    ang = rng.normal(0, 0.15, B)
    off = rng.normal(0, 0.1, (B, 2))
    rot = np.stack([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    src = (np.einsum("ijb,bnj->bni", rot, tgt) + off[:, None]
           + rng.normal(0, 0.005, (B, P, 2)))
    z = np.zeros((B, P, 1))
    src3 = np.concatenate([src, z], -1).astype(npd)
    tgt3 = np.concatenate([tgt, z], -1).astype(npd)
    smask = rng.random((B, P)) > 0.05
    tmask = rng.random((B, P)) > 0.05
    smask[1, :] = False  # no valid source point: error 0, one iteration
    tmask[2, 5:] = False  # almost every target masked
    init = np.tile(np.eye(4, dtype=npd), (B, 1, 1))
    init[3, :2, 3] = [0.05, -0.04]
    return src3, tgt3, smask, tmask, init


# float64 runs with tight stopping rules (many iterations); float32 with
# the pipeline's own (scan matching: epsilon 1e-3, loop closures: 1e-2
# normalized), since tight thresholds sit below float32's resolution of
# the error and would compare rounding noise
ICP_RULES = {("f64", False): (1e-6, 1e-7), ("f64", True): (1e-9, 1e-7),
             ("f32", False): (1e-3, 1e-4), ("f32", True): (1e-2, 1e-4)}


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_run_icp_batch_matches_jax(dt, normalize):
    npd, tdt, _ = DTYPES[dt]
    tol = 1e-9 if dt == "f64" else 1e-5
    eps, thresh = ICP_RULES[dt, normalize]
    args = _icp_pairs(0, 9, 96, npd)
    with _jax_dtype_ctx(npd):
        jr = jicp.run_icp_batch(*map(jnp.asarray, args), epsilon=eps,
                                max_iters=40, stopping_thresh=thresh,
                                normalize_error=normalize, planar=True)
        jT, jerr, jk, jidx = map(np.asarray, jr)
    tr = ticp.run_icp_batch(*map(torch.from_numpy, args), epsilon=eps,
                            max_iters=40, stopping_thresh=thresh,
                            normalize_error=normalize)
    np.testing.assert_array_equal(tr.iters.numpy(), jk)
    assert jk.max() > 2 and jk[1] == 1  # real iterations; the empty pair stops
    _cmp(tr.T, jT, tol)
    np.testing.assert_allclose(tr.error.numpy(), jerr,
                               rtol=1e-6 if dt == "f64" else 1e-3,
                               atol=1e-12)
    if dt == "f64":
        np.testing.assert_array_equal(tr.correspondences.numpy(), jidx)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_icp_all_pairs_matches_jax_on_scans(dt):
    """Consecutive real scan pairs through the chunked, padded batch: the
    JAX package's phased schedule and the port's chunked one give each pair
    the same iteration count and transform."""
    npd, tdt, _ = DTYPES[dt]
    tol = 1e-9 if dt == "f64" else 1e-5
    d = jio.synthetic_dataset(n_steps=40, n_rays=181, seed=9)
    cfg = LidarConfig(n_rays=181)
    ranges = d["lidar"]["ranges"].astype(npd)
    odo = d["ground_truth"].astype(npd)
    with _jax_dtype_ctx(npd):
        jp, jm = jscan.scans_to_points(jnp.asarray(ranges), 0.1, 30.0, cfg)
        jres = jsm.poses_from_scan_matching(jnp.asarray(odo), jp, jm,
                                            chunk_size=16)
        jposes, jit = np.asarray(jres.poses), np.asarray(jres.iters)
    tp, tm = tscan.scans_to_points(torch.from_numpy(ranges), 0.1, 30.0, cfg)
    tres = tsm.poses_from_scan_matching(torch.from_numpy(odo), tp, tm,
                                        chunk_size=16)
    np.testing.assert_array_equal(tres.iters.numpy(), jit)
    assert jit.max() > 2
    _cmp(tres.poses, jposes, tol * 10)


def test_lift_to_3d():
    p = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(
        ticp.lift_to_3d(p).numpy(),
        np.asarray(jicp.lift_to_3d(jnp.asarray(p.numpy()))))
    assert ticp.lift_to_3d(ticp.lift_to_3d(p)).shape == (3, 3)


# -- TrICP and PLICP ---------------------------------------------------------

def _rot2(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1.0]])


def _scanlike_cloud(rng, n=240):
    """tests/test_icp.py's ray-ordered points along two walls."""
    a = np.stack([np.linspace(-3, 1, n // 2), np.full(n // 2, 2.0),
                  np.zeros(n // 2)], 1)
    b = np.stack([np.full(n - n // 2, 1.0),
                  np.linspace(2.0, -2.0, n - n // 2),
                  np.zeros(n - n // 2)], 1)
    return np.concatenate([a, b]) + rng.normal(0, 0.002, (n, 3)) * [1, 1, 0]


def _partial_overlap(seed=11):
    """tests/test_icp.py's partial-overlap pair: 60% common structure."""
    rng = np.random.default_rng(seed)
    common = np.concatenate([
        np.stack([np.linspace(-2, 2, 120), np.full(120, 1.5),
                  np.zeros(120)], 1),
        np.stack([np.full(120, -2.0), np.linspace(-1.5, 1.5, 120),
                  np.zeros(120)], 1)])
    common += rng.normal(0, 0.005, common.shape)
    a_side = np.stack([np.linspace(2.5, 4.5, 160), np.full(160, -1.0),
                       np.zeros(160)], 1) + rng.normal(0, 0.005, (160, 3))
    b_side = np.stack([np.linspace(3.0, 5.0, 160), np.full(160, -2.0),
                       np.zeros(160)], 1) + rng.normal(0, 0.005, (160, 3))
    t = np.array([0.25, -0.15, 0.0])
    return (np.concatenate([common, a_side]),
            np.concatenate([common @ _rot2(0.12).T + t, b_side]))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_scan_normals_and_plicp_fit_match_jax(dt):
    """scan_normals_planar (validity equal; normals within tol) and
    fit_point_to_line_planar (transforms within 10 tol) on a scan-like
    cloud with holes and a depth jump, against the JAX functions."""
    npd, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(20)
    pts = np.stack([_scanlike_cloud(rng)[:, :2]] * 3).astype(npd)
    pts[1, 100:110] += 1.0  # a depth discontinuity
    mask = rng.random(pts.shape[:2]) > 0.05
    q = (pts @ _rot2(0.05)[:2, :2].T + [0.03, -0.02]).astype(npd)
    w = rng.random(pts.shape[:2]) > 0.2
    with _jax_dtype_ctx(npd):
        jn, jv = jkabsch.scan_normals_planar(jnp.asarray(pts),
                                             jnp.asarray(mask))
        jT = jkabsch.fit_point_to_line_planar(jnp.asarray(pts),
                                              jnp.asarray(q), jn,
                                              jnp.asarray(w & np.asarray(jv)))
        jn, jv, jT = map(np.asarray, (jn, jv, jT))
    tn, tv = tkabsch.scan_normals_planar(torch.from_numpy(pts),
                                         torch.from_numpy(mask))
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert not jv[:, 0].any() and not jv[:, -1].any() and jv.mean() > 0.8
    assert not jv[1, 99:111].all()
    _cmp(tn, jn, tol)
    tT = tkabsch.fit_point_to_line_planar(
        torch.from_numpy(pts), torch.from_numpy(q), tn,
        torch.from_numpy(w) & tv)
    _cmp(tT, jT, 10 * tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_trim_mask_matches_jax(dt):
    """_trim_mask against JAX's: distances quantized so that ties sit at
    the threshold (all kept), invalid points never kept, a pair with no
    valid point, q from 0.1 to 0.9."""
    npd, _, _ = DTYPES[dt]
    rng = np.random.default_rng(3)
    d2 = np.round(rng.random((4, 300)) * 20).astype(npd) / 20
    mask = rng.random((4, 300)) > 0.2
    mask[3] = False
    for q in (0.1, 0.55, 0.9):
        with _jax_dtype_ctx(npd):
            want = np.asarray(jicp._trim_mask(jnp.asarray(d2),
                                              jnp.asarray(mask), q))
        got = ticp._trim_mask(torch.from_numpy(d2), torch.from_numpy(mask),
                              q).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[~mask].any() and got[0].sum() > q * mask[0].sum()


@pytest.mark.parametrize("case", ["tricp", "plicp"])
def test_tricp_and_plicp_run_icp_batch_match_jax(case):
    """run_icp_batch with trim_fraction 0.55 on the partial-overlap pair
    and with metric point_to_line on the interleaved scan-like walls
    (tests/test_icp.py), float64 with tight stopping rules: iteration
    counts equal, transforms within 1e-9; the trimmed fit recovers the
    true translation within 0.02 m and PLICP within 2e-3 m."""
    if case == "tricp":
        src, tgt = _partial_overlap()
        kw = dict(trim_fraction=0.55)
        t_true, bound = np.array([0.25, -0.15]), 0.02
    else:
        src = _scanlike_cloud(np.random.default_rng(21))
        tgt = (_scanlike_cloud(np.random.default_rng(22), n=173)
               @ _rot2(0.06).T + [0.10, -0.06, 0.0])
        kw = dict(metric="point_to_line")
        t_true, bound = np.array([0.10, -0.06]), 2e-3
    args = (src[None], tgt[None], np.ones((1, len(src)), bool),
            np.ones((1, len(tgt)), bool), np.eye(4)[None])
    rules = dict(epsilon=1e-12, stopping_thresh=1e-10, max_iters=200)
    jr = jicp.run_icp_batch(*map(jnp.asarray, args), planar=True, **rules,
                            **kw)
    tr = ticp.run_icp_batch(*map(torch.from_numpy, args), **rules, **kw)
    assert int(tr.iters[0]) == int(jr.iters[0]) > 2
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), rtol=0,
                               atol=1e-9)
    assert np.linalg.norm(tr.T.numpy()[0, :2, 3] - t_true) < bound


@pytest.mark.parametrize("metric", ["point_to_line", "point"])
def test_plicp_scan_matching_matches_jax(metric):
    """poses_from_scan_matching under each metric on a 271-ray synthetic
    log (tests/test_icp.py:419-440), float64: per-pair iteration counts
    equal (the cycle stop bounds PLICP below 50), poses within 1e-8."""
    from lidar_slam_tpu.config import IcpConfig as JIcp
    from lidar_slam_tpu_torch.config import IcpConfig as TIcp

    d = jio.synthetic_dataset(n_steps=40, n_rays=271, seed=3)
    cfg = LidarConfig(n_rays=271)
    ranges = d["lidar"]["ranges"]
    odo = np.asarray(j_odo.poses_from_odometry(
        jnp.asarray(d["encoder"]["counts"]),
        jnp.asarray(d["imu"]["angular_velocity"])))
    jp, jm = jscan.scans_to_points(jnp.asarray(ranges), 0.1, 30.0, cfg)
    jres = jsm.poses_from_scan_matching(
        jnp.asarray(odo), jp, jm, JIcp(epsilon=0.001, metric=metric),
        chunk_size=8)
    tp, tm = tscan.scans_to_points(torch.from_numpy(ranges), 0.1, 30.0, cfg)
    tres = tsm.poses_from_scan_matching(
        torch.from_numpy(odo), tp, tm, TIcp(epsilon=0.001, metric=metric),
        chunk_size=16)
    np.testing.assert_array_equal(tres.iters.numpy(), np.asarray(jres.iters))
    assert 2 < int(tres.iters.max()) < 50
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses),
                               rtol=0, atol=1e-8)


# -- full width (1,081 rays): where the port and XLA's CPU rounding part ----
#
# On the CPU, XLA sums the Kabsch centroids as a tree of 32-wide windows
# and the cross-covariance as one sequential fused multiply-add chain over
# the points; torch reduces in its own blocked orders, on the CPU and on
# the card. So the fit differs from JAX's by a few ULPs from the first
# iteration on (fed JAX's sums, the port's atan2/cos/sin tail is
# bit-equal); later iterations meet nearest-neighbour near-ties, which the
# ULPs flip; and a flip can carry |last_err - err| across the 1e-4 stop.
# The two tests pin each link: one iteration from JAX's own transform, and
# the whole scan matching.

FULL = dict(n_steps=40, n_rays=1081, seed=21)
ULP1 = 2.0 ** -23  # float32 ULP of 1.0
STEP_T_ULPS = 16  # one iteration from JAX's T (measured 11.8)
FLIP_GAP_ULPS = 4  # a flip's distance gap in ULPs of |t|^2 (measured 2.3)
FULL_POSE_TOL = 3e-3  # whole scan matching, poses (measured 2.74e-3)
FULL_ITER_PAIRS = 5  # pairs of 39 whose iteration count differs (measured)


@pytest.fixture(scope="module")
def full_width_log():
    """JAX's own float32 points, masks and odometry of a 40-step log at
    1,081 rays, and JAX's scan matching of it (chunk 16)."""
    from lidar_slam_tpu import sensors as jsens
    from lidar_slam_tpu.config import SlamConfig as JSlam

    d = jio.synthetic_dataset(**FULL)
    enc = jsens.Encoder.from_data(d["encoder"])
    lid = jsens.Lidar.from_data(d["lidar"])
    imu = jsens.Imu.from_data(d["imu"])
    jsens.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
    cfg = JSlam()
    with jax.enable_x64(False):
        pts, masks = jscan.scans_to_points(
            jnp.asarray(lid.ranges_synced.astype(np.float32)), 0.1, 30.0,
            cfg.lidar)
        odo = j_odo.poses_from_odometry(
            jnp.asarray(enc.counts_synced.astype(np.float32)),
            jnp.asarray(imu.gyro_synced.astype(np.float32)))
        sm = jsm.poses_from_scan_matching(odo, pts, masks, cfg.icp,
                                          chunk_size=16)
        return dict(pts=np.array(pts), masks=np.array(masks),
                    odo=np.array(odo), poses=np.asarray(sm.poses),
                    iters=np.asarray(sm.iters))


def test_icp_one_iteration_from_jax_transform_full_width(full_width_log):
    """Every iteration of every pair of the log: the port's icp_iteration
    from JAX's own transform T_k against JAX's T_{k+1}. Where no index
    flips, T within STEP_T_ULPS ULPs of 1.0; every flipped index a near-tie
    whose two targets' true squared distances differ by at most
    FLIP_GAP_ULPS ULPs of |t|^2 (the rounding scale of the NN's
    |t|^2 - 2 s.t)."""
    g = full_width_log
    pts3 = np.concatenate([g["pts"], np.zeros(g["pts"].shape[:-1] + (1,),
                                              np.float32)], -1)
    src, tgt, sm, tm = pts3[1:], pts3[:-1], g["masks"][1:], g["masks"][:-1]
    with jax.enable_x64(False):
        seeds = jse2.TSE3_from_TSE2(jse2.get_relative_pose(
            jnp.asarray(g["odo"][:-1]), jnp.asarray(g["odo"][1:])))
        # the clouds are ARGUMENTS of the jitted step: folded in as
        # constants, XLA evaluates parts of it in yet another order
        step = jax.jit(lambda a, b, m1, m2, c: jicp.icp_step_batch(
            a, b, m1, m2, c, 1e-3, 2000, 1e-4, False, True, "jnp"))
        c = jicp.initial_icp_carry(seeds, src.shape[0], src.shape[1],
                                   jnp.float32)
        hist = [c]
        while not bool(np.asarray(c.done).all()):
            c = step(*map(jnp.asarray, (src, tgt, sm, tm)), c)
            hist.append(c)
    np.testing.assert_array_equal(np.asarray(c.k), g["iters"])
    ts, tt, tsm, ttm = map(torch.from_numpy, (src, tgt, sm, tm))
    worst_T, worst_gap, flips = 0.0, 0.0, 0
    for before, after in zip(hist[:-1], hist[1:]):
        live = ~np.asarray(before.done)
        T_k = np.asarray(before.T)
        T_next, idx, _ = ticp.icp_iteration(ts, tt, tsm, ttm,
                                            torch.from_numpy(T_k))
        j_idx = np.asarray(after.idx)
        flip = (idx.numpy() != j_idx) & live[:, None] & sm
        same = live & ~flip.any(-1)
        dT = np.abs(T_next.numpy() - np.asarray(after.T)).max((-1, -2))
        worst_T = max(worst_T, float(dT[same].max(initial=0.0)))
        src_t = (np.einsum("bij,bnj->bni", T_k[:, :3, :3].astype(np.float64),
                           src) + T_k[:, None, :3, 3])
        for b, n in zip(*np.nonzero(flip)):
            t_j = tgt[b, j_idx[b, n]].astype(np.float64)
            d_t = ((src_t[b, n] - tgt[b, idx[b, n]]) ** 2).sum()
            d_j = ((src_t[b, n] - t_j) ** 2).sum()
            worst_gap = max(worst_gap, abs(d_t - d_j) / (t_j @ t_j) / ULP1)
        flips += int(flip.sum())
    print(f"one iteration from JAX's T, {len(hist) - 1} iterations: T within "
          f"{worst_T / ULP1:.2f} ULPs where no index flips; {flips} flips, "
          f"gaps within {worst_gap:.2f} ULPs of |t|^2")
    assert worst_T <= STEP_T_ULPS * ULP1, worst_T / ULP1
    assert worst_gap <= FLIP_GAP_ULPS, (worst_gap, flips)
    assert len(hist) > 10


def test_scan_matching_full_width_bound(full_width_log):
    """The whole scan matching on JAX's own points: poses within
    FULL_POSE_TOL of JAX's and at most FULL_ITER_PAIRS of the 39 pairs
    with another iteration count (the near-tie flips above carrying the
    1e-4 stop); everywhere else equal."""
    g = full_width_log
    res = tsm.poses_from_scan_matching(
        torch.from_numpy(g["odo"]), torch.from_numpy(g["pts"]),
        torch.from_numpy(g["masks"]), chunk_size=16)
    differ = int((res.iters.numpy() != g["iters"]).sum())
    gap = float(np.abs(res.poses.numpy() - g["poses"]).max())
    print(f"scan matching at 1,081 rays: {differ} of {len(g['iters'])} "
          f"pairs with another iteration count, poses within {gap:.3e}")
    assert differ <= FULL_ITER_PAIRS, differ
    assert gap <= FULL_POSE_TOL, gap
