"""The port's multi-rank layer against the JAX package's, on the CPU.

One module-scoped fixture spawns 4 gloo ranks once (parallel/launch.
run_ranks); each rank builds a ("dp",) mesh and a (2, 2) ("dp", "rp") mesh
over them and runs every case (tests/torch_parallel_ranks.parallel_cases),
and rank 0's results come back here. Each case is held against two
oracles, fed the same numpy inputs: the JAX package's sharded function on
make_mesh(4) (or its (2, 2) mesh) of the 8-device CPU mesh that
tests/conftest.py sets up, and the port's own single-device function.
Tolerances are the JAX package's own (tests/test_parallel.py,
tests/test_clamp_affine.py):

  - clamp_affine: bit-equal to JAX on integer deltas and on unsaturated
    float deltas, within 1e-4 at saturated cells;
  - both map builders (rays and scans padded, with init=): within 1e-4 of
    the single-device builds and of JAX's, finalize_grid equal (the psum
    and the block composition reassociate float adds);
  - the ICP pairs: iterations equal, T within 1e-9 (float64);
  - PF and relocalization scores and searches, and both paints: bit-equal
    to the port's single-device results and equal to JAX's;
  - optimize_sharded (float64): poses within 2e-5 and cost within 1e-4
    relative of the single-device banded solve and of JAX's sharded one,
    iterations within one; the Huber case with a corrupted arc within
    5e-3 (its optimum is a flat valley, tests/test_parallel.py:610-616);
    a live arc wider than the band raises on both entry points.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import occupancy as jocc
from lidar_slam_tpu.models import pose_graph as jpg
from lidar_slam_tpu.models import relocalization as jrl
from lidar_slam_tpu.ops import clamp_affine as jca
from lidar_slam_tpu.parallel import mesh as jmesh
from lidar_slam_tpu.parallel import sharding as jsh

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.models import particle_filter as tpf
from lidar_slam_tpu_torch.models import pf_slam as tps
from lidar_slam_tpu_torch.models import pose_graph as tpg
from lidar_slam_tpu_torch.models import relocalization as trl
from lidar_slam_tpu_torch.models import texture as ttex
from lidar_slam_tpu_torch.ops import clamp_affine as tca
from lidar_slam_tpu_torch.ops import icp as ticp
from lidar_slam_tpu_torch.ops import scan as tscan
from lidar_slam_tpu_torch.parallel import launch
from lidar_slam_tpu_torch.parallel import mesh as tmesh
from lidar_slam_tpu_torch.parallel import sharding as tsh
from lidar_slam_tpu_torch.utils import interop, native
from lidar_slam_tpu_torch.utils import io as tio

import torch_parallel_ranks

torch.set_num_threads(1)

CLIP = 20.0
MAP_TOL, SAT_TOL = 1e-4, 1e-4
ICP_TOL = 1e-9
PG_POSE_TOL, PG_COST_RTOL, PG_ROBUST_TOL = 2e-5, 1e-4, 5e-3
T = torch.from_numpy
MAPS = dict(resolution=0.1, world_max_x=6, world_min_x=-6, world_max_y=6,
            world_min_y=-6)  # 121 x 121
TEX = dict(resolution=0.2, world_max_x=6, world_min_x=-6, world_max_y=6,
           world_min_y=-6)
RELOC = dict(world_max_x=3.2, world_min_x=-3.2, world_max_y=3.2,
             world_min_y=-3.2, resolution=0.05)
RELOC_CFG = dict(n_angles=8, search_radius=0.8, n_levels=3, beam=64,
                 max_rays=64, score_chunk=512)
PF_MAP = dict(resolution=0.25, world_max_x=15, world_min_x=-15,
              world_max_y=15, world_min_y=-15)  # 121 x 121


def _scans(rng, N, R, rmax=5.0, step=0.05):
    poses = np.cumsum(rng.normal(0, step, (N, 3)), axis=0).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (N, R))
    r = rng.uniform(0.3, rmax, (N, R))
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    return poses, pts, rng.random((N, R)) > 0.05


def _pad(a, n, axis, value=0):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(a, widths, constant_values=value)


def _pg_problem(rng, n, interval=10, noise=0.05, dtype=np.float64):
    """tests/test_parallel.py's fixed-interval problem: a noisy circle
    and exact loop arcs, one gated out."""
    def T_from_pose(p):
        c, s = np.cos(p[:, 2]), np.sin(p[:, 2])
        out = np.zeros((len(p), 3, 3))
        out[:, 0, 0], out[:, 0, 1], out[:, 0, 2] = c, -s, p[:, 0]
        out[:, 1, 0], out[:, 1, 1], out[:, 1, 2] = s, c, p[:, 1]
        out[:, 2, 2] = 1.0
        return out

    t = np.linspace(0, 2 * np.pi, n)
    gt = np.stack([np.cos(t) * 5, np.sin(t) * 5, t + np.pi / 2], -1)
    Tg = T_from_pose(gt)
    rel = np.einsum("nij,njk->nik", np.linalg.inv(Tg[:-1]), Tg[1:])
    rel[:, :2, 2] += rng.normal(0, 0.01, (n - 1, 2))
    li = np.arange(0, n - interval, interval, dtype=np.int64)
    lj = li + interval
    lmeas = np.einsum("nij,njk->nik", np.linalg.inv(Tg[li]), Tg[lj])
    lmask = np.ones(len(li), bool)
    lmask[1] = False
    poses0 = gt + rng.normal(0, noise, gt.shape)
    return dict(poses0=poses0.astype(dtype), rel=rel.astype(dtype),
                loops=(li, lj, lmeas.astype(dtype), lmask))


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    # ICP pairs (tests/test_parallel.py's _pairs, B = 16, P = 64)
    B, P = 16, 64
    src = rng.normal(size=(B, P, 3)) * [1, 1, 0.2]
    tgt = np.empty_like(src)
    for b in range(B):
        yaw = rng.uniform(-0.2, 0.2)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        tgt[b] = src[b] @ R.T + rng.uniform(-0.1, 0.1, 3)
    icp = dict(src=src, tgt=tgt, mask=np.ones((B, P), bool),
               T0=np.tile(np.eye(4), (B, 1, 1)))

    # maps: 62 rays padded to 64, 11 scans padded to 12, a stationary
    # robot whose cells saturate
    cfg = tc.MapConfig(**MAPS)
    K = tocc.max_ray_cells(cfg, 6.0)
    poses, pts, masks = _scans(rng, 6, 62)
    init = np.clip(rng.normal(0, 2.0, (cfg.width, cfg.height)), -CLIP,
                   CLIP).astype(np.float32)
    rays = dict(poses=poses, pts=_pad(pts, 64, 1),
                masks=_pad(masks, 64, 1, False), init=init, n_rays=62)
    poses, pts, masks = _scans(rng, 11, 32)
    scans = dict(poses=_pad(poses, 12, 0), pts=_pad(pts, 12, 0),
                 masks=_pad(masks, 12, 0, False), init=init, n_scans=11)
    N, R = 48, 32
    ang = np.tile(np.linspace(-np.pi, np.pi, R, endpoint=False), (N, 1))
    r = 4.0 + rng.normal(0, 0.02, (N, R))
    sat = dict(poses=rng.normal(0, 0.01, (N, 3)).astype(np.float32),
               pts=np.stack([r * np.cos(ang), r * np.sin(ang)],
                            -1).astype(np.float32),
               masks=np.ones((N, R), bool), init=None, n_scans=N)
    maps = dict(cfg=MAPS, K=K, rays=rays, scans=scans, saturating=sat)

    # texture: 16 frames of 24 x 32 in two batches of 8
    tcfg = tc.MapConfig(**TEX)
    cam = tc.CameraConfig()
    disp = rng.integers(300, 900, (16, 24, 32)).astype(np.uint16)
    rgb = rng.integers(0, 256, (16, 24, 32, 3)).astype(np.uint8)
    tposes = rng.normal(0, 0.8, (16, 3)).astype(np.float32)
    ops = [ttex._pad_paint_ops(*native.project_frames(
        disp[s:s + 8], rgb[s:s + 8], tposes[s:s + 8].astype(np.float64),
        cam, tcfg), min_pad=64) for s in (0, 8)]
    texture = dict(cfg=TEX, disp=disp.astype(np.float32), rgb=rgb,
                   poses=tposes, ops=ops)

    # relocalization: tests/test_parallel.py's random map and scan
    rmap = jc.MapConfig(**RELOC)
    im = (rng.random((rmap.width, rmap.height)) > 0.85).astype(np.float32)
    rpts = rng.uniform(-3, 3, (181, 2)).astype(np.float32)
    rmask = rng.random(181) > 0.1
    jb = jrl._base_cells(jnp.asarray(rpts), jnp.asarray(rmask),
                         jnp.zeros(2, jnp.float32),
                         trl._angles(trl.RelocConfig(**RELOC_CFG)), rmap,
                         RELOC_CFG["max_rays"])
    reloc = dict(cfg=RELOC, reloc_cfg=RELOC_CFG, im=im, pts=rpts,
                 mask=rmask, jax_base=tuple(np.asarray(a) for a in jb))

    # particle filters: a 48-step log of 181 rays on a 121 x 121 map
    pmap = tc.MapConfig(**PF_MAP)
    d = tio.synthetic_dataset(n_steps=48, n_rays=181, seed=5)
    gt = np.asarray(d["ground_truth"], np.float32)
    ppts, pmasks = tscan.scans_to_points(
        torch.as_tensor(d["lidar"]["ranges"], dtype=torch.float32), 0.1,
        30.0, tc.LidarConfig())
    ppts = ppts[..., :2].contiguous()
    pK = tocc.adaptive_ray_cells(ppts, pmasks, pmap, 30.0)
    pim = (tocc.build_logodds(T(gt), ppts, pmasks, pmap, pK) > 0).float()
    n_p = 64
    pf = dict(cfg=PF_MAP, K=pK, gt=gt, pts=ppts.numpy(),
              masks=pmasks.numpy(), im=pim.numpy(),
              counts=np.asarray(d["encoder"]["counts"], np.float32) * 1.1,
              gyro=np.asarray(d["imu"]["angular_velocity"], np.float32),
              particles=(gt[7] + rng.normal(0, 0.3, (n_p, 3))
                         ).astype(np.float32),
              noise=(rng.standard_normal((47, n_p)).astype(np.float32),
                     rng.standard_normal((47, n_p)).astype(np.float32),
                     rng.random(47).astype(np.float32)))

    # pose graphs (float64): 53 poses (52 between factors pad to 52, 5
    # loops to 8 on 4 ranks), 41 with no loops, 64 with a corrupted arc
    # under Huber, and a wide live arc
    loops53 = _pg_problem(np.random.default_rng(3), 53)
    chain = _pg_problem(np.random.default_rng(11), 41)
    chain["loops"] = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                      np.zeros((0, 3, 3)), np.zeros(0, bool))
    robust = _pg_problem(np.random.default_rng(5), 64)
    robust["loops"][2][2, 0, 2] += 1.5
    robust["cfg"] = dict(solver="banded", fixed_interval=10,
                         robust_loss="huber", robust_delta=1.0,
                         max_lm_iters=40, cost_rtol=1e-9)
    wide = _pg_problem(np.random.default_rng(7), 53)
    wide["loops"][1][0] = 30  # span 30 > band 10
    pose_graph = dict(cases={"loops53": loops53, "no_loops": chain,
                             "robust": robust}, wide=wide)
    return dict(icp=icp, maps=maps, texture=texture, reloc=reloc, pf=pf,
                pose_graph=pose_graph)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranked(inputs):
    return launch.run_ranks(torch_parallel_ranks.parallel_cases, 4, None,
                            "cpu", inputs)


# -- clamp-affine algebra, no ranks -----------------------------------

def _deltas(kind):
    rng = np.random.default_rng({"integers": 0, "unsaturated": 1,
                                 "saturated": 2}[kind])
    if kind == "integers":
        return rng.integers(-7, 8, size=(60, 257)).astype(np.float32)
    scale = 0.3 if kind == "unsaturated" else 6.0
    return rng.normal(0, scale, (60, 257)).astype(np.float32)


def _sequential(deltas, v0):
    v = v0.copy()
    for d in deltas:
        v = np.clip(v + d, -CLIP, CLIP)
    return v


@pytest.mark.parametrize("kind", ["integers", "unsaturated", "saturated"])
def test_clamp_affine_composes_as_jax(kind):
    """Per-scan updates composed in 4 blocks through compose_tree and
    applied to the zero grid: bit-equal to JAX on integer and unsaturated
    float deltas (the same float32 ops), within 1e-4 at saturated cells;
    bit-equal to the sequential clip on integers (every value exact),
    within 1e-4 of it on floats (the blocks' sums reassociate)."""
    deltas = _deltas(kind)
    v0 = np.zeros(257, np.float32)
    ref = _sequential(deltas, v0)
    got = {}
    for name, ca, arr in (("jax", jca, jnp.asarray), ("port", tca, T)):
        blocks = []
        for blk in np.split(deltas, 4):
            kw = {} if name == "jax" else dict(dtype=torch.float32)
            f = ca.identity((257,), CLIP, **kw)
            for d in blk:
                f = ca.update(f, arr(d), CLIP)
            blocks.append(f)
        got[name] = np.asarray(ca.apply(ca.compose_tree(blocks), arr(v0)))
    saturated = bool((np.abs(ref) == CLIP).any())
    assert saturated == (kind != "unsaturated")
    if kind == "saturated":
        np.testing.assert_allclose(got["port"], got["jax"], atol=SAT_TOL)
    else:
        np.testing.assert_array_equal(got["port"], got["jax"])
    if kind == "integers":
        np.testing.assert_array_equal(got["port"], ref)
    else:
        np.testing.assert_allclose(got["port"], ref, atol=SAT_TOL)


@pytest.mark.parametrize("op", ["update_vs_compose", "tree_vs_fold",
                                "associative"])
def test_clamp_affine_algebra(op):
    """update is compose with (delta, -clip, clip); compose_tree equals the
    left fold; compose is associative (integer deltas, exact)."""
    rng = np.random.default_rng(2)
    blocks = []
    for _ in range(5):
        f = tca.identity((128,), CLIP)
        for d in rng.integers(-6, 7, size=(12, 128)).astype(np.float32):
            f = tca.update(f, T(d), CLIP)
        blocks.append(f)
    if op == "update_vs_compose":
        d = T(rng.integers(-9, 10, 128).astype(np.float32))
        g = tca.ClampAffine(d, torch.full((128,), -CLIP),
                            torch.full((128,), CLIP))
        a, b = tca.update(blocks[0], d, CLIP), tca.compose(blocks[0], g)
    elif op == "tree_vs_fold":
        a = tca.compose_tree(list(blocks))
        b = blocks[0]
        for f in blocks[1:]:
            b = tca.compose(b, f)
    else:
        a = tca.compose(tca.compose(blocks[0], blocks[1]), blocks[2])
        b = tca.compose(blocks[0], tca.compose(blocks[1], blocks[2]))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_carry_clamp_affine():
    """A JAX triple carried across (utils/interop.carry_clamp_affine)
    applies as JAX's."""
    deltas = _deltas("saturated")
    f = jca.identity((257,), CLIP, dtype=jnp.float32)
    for d in deltas:
        f = jca.update(f, jnp.asarray(d), CLIP)
    v0 = np.linspace(-CLIP, CLIP, 257).astype(np.float32)
    carried = interop.carry_clamp_affine(f)
    assert isinstance(carried, tca.ClampAffine)
    assert all(t.dtype == torch.float32 for t in carried)
    np.testing.assert_array_equal(tca.apply(carried, T(v0)).numpy(),
                                  np.asarray(jca.apply(f, jnp.asarray(v0))))


# -- mesh, pad_batch ----------------------------------------------------

@pytest.mark.parametrize("n,axes", [(8, ("dp",)), (8, ("dp", "rp")),
                                    (4, ("dp", "rp")), (6, ("dp", "rp")),
                                    (2, ("dp", "rp"))])
def test_mesh_shape_as_jax(n, axes):
    assert (tmesh.mesh_shape(n, axes)
            == jmesh.make_mesh(n, axes=axes).devices.shape)


def test_mesh_ranks(ranked):
    """The ranks sit on the (2, 2) mesh as JAX lays its devices (row
    major), under gloo on the CPU; batch_sharding hands each its block."""
    m = ranked["mesh"]
    assert m["shape_1d"] == {"dp": 4}
    assert m["shape_2d"] == {"dp": 2, "rp": 2}
    assert m["backend"] == "gloo"
    want = [[k // 2, k % 2, k] for k in range(4)]
    assert m["coords"].tolist() == want
    # batch_sharding: rank k holds block k of a padded batch
    assert m["blocks"].tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m["replicated"].tolist() == [0, 1, 2]
    calls, nbytes = ranked["collectives"]
    assert calls > 50 and nbytes > 0


@pytest.mark.parametrize("shape,multiple,axis,value", [
    ((5, 3), 8, 0, 0), ((5, 3), 5, 0, 0), ((2, 7), 4, 1, -1),
    ((3, 6), 4, 1, False)])
def test_pad_batch_as_jax(shape, multiple, axis, value):
    x = np.arange(np.prod(shape)).reshape(shape)
    if value is False:
        x = x % 2 == 0
    jx, jpad = jsh.pad_batch(jnp.asarray(x), multiple, axis=axis,
                             pad_value=value)
    tx, tpad = tsh.pad_batch(T(x), multiple, axis=axis, pad_value=value)
    assert tpad == jpad
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_unsharded_axis_raises(ranked):
    assert "not divisible" in ranked["paint_ops_uneven"]


# -- ICP ----------------------------------------------------------------

def test_sharded_icp_batch(inputs, ranked):
    c = inputs["icp"]
    got = ranked["icp"]
    single = ticp.run_icp_batch(*map(T, (c["src"], c["tgt"], c["mask"],
                                         c["mask"], c["T0"])), epsilon=1e-8,
                                planar=True)
    jgot = jsh.sharded_icp_batch(jmesh.make_mesh(4))(
        *map(jnp.asarray, (c["src"], c["tgt"], c["mask"], c["mask"],
                           c["T0"])), epsilon=1e-8, planar=True)
    for ref in (single, jgot):
        np.testing.assert_array_equal(got.iters.numpy(),
                                      np.asarray(ref.iters))
        np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T),
                                   atol=ICP_TOL, rtol=0)
        np.testing.assert_array_equal(got.correspondences.numpy(),
                                      np.asarray(ref.correspondences))
    assert int(got.iters.max()) > 2


# -- maps -----------------------------------------------------------------

def _assert_map(got, refs, tol=MAP_TOL):
    for ref in refs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)
        np.testing.assert_array_equal(
            tocc.finalize_grid(got).numpy(),
            tocc.finalize_grid(torch.as_tensor(ref)).numpy())


@pytest.mark.parametrize("case", ["rays", "rays_rp"])
def test_ray_sharded_map(inputs, ranked, case):
    """The ray split, 62 rays padded to 64 with mask=False: over "dp" of
    the 1-D mesh from zeros, against JAX's ray-sharded builder (which
    takes no init) and both packages' single-device builds; over "rp" of
    the (2, 2) mesh from a random carried grid (init=), against both
    single-device builds from that grid."""
    m = inputs["maps"]
    c = m["rays"]
    tcfg, jcfg = tc.MapConfig(**MAPS), jc.MapConfig(**MAPS)
    n = c["n_rays"]
    args = (c["poses"], c["pts"][:, :n], c["masks"][:, :n])
    init = None if case == "rays" else c["init"]
    kw = {} if init is None else {"init": init}
    single = tocc.build_logodds(*map(T, args), tcfg, m["K"],
                                **{k: T(v) for k, v in kw.items()})
    jsingle = jocc.build_logodds(*map(jnp.asarray, args), jcfg, m["K"],
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    refs = [single, jsingle]
    if init is None:
        refs.append(jsh.sharded_build_logodds(jmesh.make_mesh(4), jcfg,
                                              m["K"])(
            *map(jnp.asarray, (c["poses"], c["pts"], c["masks"]))))
    got = ranked[f"map_{case}"]
    _assert_map(got, refs)
    assert int((got != (0 if init is None else T(init))).sum()) > 200


@pytest.mark.parametrize("case", ["scans", "saturating"])
def test_scan_sharded_map(inputs, ranked, case):
    """The scan split through clamp-affine composition: 11 scans padded to
    12 from a random carried grid, and 48 scans of a stationary robot
    whose cells saturate at the rails; against the single-device builds
    and JAX's scan-sharded builder."""
    m = inputs["maps"]
    c = m[case]
    tcfg, jcfg = tc.MapConfig(**MAPS), jc.MapConfig(**MAPS)
    n = c["n_scans"]
    args = (c["poses"][:n], c["pts"][:n], c["masks"][:n])
    init = c["init"]
    single = tocc.build_logodds(*map(T, args), tcfg, m["K"],
                                init=None if init is None else T(init))
    jbuild = jsh.sharded_build_logodds_scans(jmesh.make_mesh(4), jcfg,
                                             m["K"])
    jargs = tuple(map(jnp.asarray, (c["poses"], c["pts"], c["masks"])))
    jgot = (jbuild(*jargs) if init is None
            else jbuild(*jargs, init=jnp.asarray(init)))
    got = ranked[f"map_{case}"]
    _assert_map(got, [single, jgot])
    if case == "saturating":
        assert float(single.abs().max()) >= CLIP - 1e-6


# -- texture --------------------------------------------------------------

def _sequential_paint(tex, cells):
    tcfg = tc.MapConfig(**TEX)
    w = torch.full((cells,), -1, dtype=torch.int32)
    c = torch.zeros(cells, dtype=torch.int32)
    base = 0
    for s in (0, 8):
        lin, cols, _ = ttex.frames_to_cells(
            T(tex["disp"][s:s + 8]), T(tex["rgb"][s:s + 8]),
            T(tex["poses"][s:s + 8]), tcfg, tc.CameraConfig())
        w, c = ttex.paint_cells(w, c, lin, cols, base)
        base += int(lin.shape[0])
    return w, c


@pytest.mark.parametrize("case", ["texture", "paint_ops"])
def test_sharded_paint(inputs, ranked, case):
    """Frame-sharded painting (two batches and an all-padding batch) and
    the op-stream shard of the host projector's ops: bit-equal to the
    sequential paint_cells / paint_ops and to JAX's sharded painters."""
    tex = inputs["texture"]
    jcfg = jc.MapConfig(**TEX)
    cells = jcfg.width * jcfg.height
    m4 = jmesh.make_mesh(4)
    jw = jnp.full((cells,), -1, jnp.int32)
    jcol = jnp.zeros((cells,), jnp.int32)
    if case == "texture":
        want = _sequential_paint(tex, cells)
        paint = jsh.sharded_texture_paint(m4, jcfg, jc.CameraConfig())
        base = 0
        for s in (0, 8):
            jw, jcol = paint(jw, jcol, jnp.asarray(tex["disp"][s:s + 8]),
                             jnp.asarray(tex["rgb"][s:s + 8]),
                             jnp.asarray(tex["poses"][s:s + 8]),
                             jnp.ones((8,), bool), jnp.int32(base))
            base += 8 * 24 * 32
    else:
        w = torch.full((cells,), -1, dtype=torch.int32)
        c = torch.zeros(cells, dtype=torch.int32)
        paint = jsh.sharded_paint_ops(m4, jcfg)
        base = 0
        for ops in tex["ops"]:
            w, c = ttex.paint_ops(w, c, T(ops), base)
            jw, jcol = paint(jw, jcol, jnp.asarray(ops), jnp.int32(base))
            base += ops.shape[1]
        want = (w, c)
    got = ranked[case]
    for g, w_, j in zip(got, want, (jw, jcol)):
        assert torch.equal(g, w_)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert int((got[0] >= 0).sum()) > 0


# -- relocalization and particle filters ---------------------------------

def test_sharded_reloc_search(inputs, ranked):
    """The node-sharded search equals the single-device one (pose, score,
    certificate, margin) bit for bit, and from JAX's base cells it equals
    JAX's node-sharded search."""
    r = inputs["reloc"]
    tmap, jmap = tc.MapConfig(**RELOC), jc.MapConfig(**RELOC)
    tcfg = trl.RelocConfig(**RELOC_CFG)
    single = trl.relocalize(T(r["im"]), tmap, T(r["pts"]), T(r["mask"]),
                            tcfg)
    jres = jrl.relocalize(jnp.asarray(r["im"]), jmap, jnp.asarray(r["pts"]),
                          jnp.asarray(r["mask"]), jrl.RelocConfig(**RELOC_CFG),
                          score_fn=jsh.sharded_reloc_score(jmesh.make_mesh(4)))
    for got, want in ((ranked["reloc"], single),
                      (ranked["reloc_jax_base"], jres)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["score", "localize", "pf_slam"])
def test_sharded_pf(inputs, ranked, case):
    """Particle-sharded scoring: the (P,) scores bit-equal to the
    single-device scorer and to JAX's sharded scorer; the localization
    and PF-SLAM runs on one noise stream bit-equal to the single-device
    runs (tracks, resample flags, map)."""
    p = inputs["pf"]
    tmap = tc.MapConfig(**PF_MAP)
    pcfg = tpf.PFConfig(n_particles=p["particles"].shape[0])
    noise = tuple(map(T, p["noise"]))
    if case == "score":
        args = (p["particles"], p["pts"][7], p["masks"][7], p["im"])
        single = tpf._score_particles(*map(T, args), tmap)
        jgot = jsh.sharded_pf_score(jmesh.make_mesh(4),
                                    jc.MapConfig(**PF_MAP))(
            *map(jnp.asarray, args))
        assert torch.equal(ranked["pf_score"], single)
        np.testing.assert_array_equal(single.numpy(), np.asarray(jgot))
        assert float(single.max()) > 20
    elif case == "localize":
        want = tpf.localize_particle_filter(
            T(p["im"]), T(p["counts"]), T(p["gyro"]), T(p["pts"]),
            T(p["masks"]), tmap, pcfg, x0=T(p["gt"][0]), noise=noise,
            device="cpu")
        got = ranked["pf_localize"]
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1]["resampled"], want[1]["resampled"])
        assert bool(want[1]["resampled"].any())
    else:
        want = tps.slam_particle_filter(
            T(p["counts"]), T(p["gyro"]), T(p["pts"]), T(p["masks"]), tmap,
            pcfg, x0=T(p["gt"][0]), K=p["K"], noise=noise, device="cpu")
        got = ranked["pf_slam"]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the factor-sharded pose graph ---------------------------------------

def _jax_pose_graph(name, c):
    li, lj, lmeas, lmask = map(jnp.asarray, c["loops"])
    m4 = jmesh.make_mesh(4)
    if name == "robust":
        run = jsh.sharded_optimize_trajectory(m4, jc.PoseGraphConfig(
            **c["cfg"]))
        return run(jnp.asarray(c["poses0"]), jnp.asarray(c["rel"]), li, lj,
                   lmeas, lmask)
    graph = jpg.make_graph(jnp.asarray(c["rel"]), loop_i=li, loop_j=lj,
                           loop_meas=lmeas, loop_mask=lmask)
    # under jit (one compile): the loop spans were checked on the host
    return jax.jit(lambda x, g: jpg.optimize_sharded(
        x, g, m4, band=10, max_iters=30, cost_rtol=1e-9))(
        jnp.asarray(c["poses0"]), graph)


@pytest.mark.parametrize("name", ["loops53", "no_loops", "robust"])
def test_optimize_sharded(inputs, ranked, name):
    """Factor-sharded LM in float64 against the single-device banded solve
    and JAX's sharded solve: 53 poses pad both factor axes, 41 carry no
    loop at all, and 64 carry a corrupted live arc under Huber."""
    c = inputs["pose_graph"]["cases"][name]
    got = ranked[f"pg_{name}"]
    li, lj, lmeas, lmask = map(T, c["loops"])
    if name == "robust":
        single = tpg.optimize_trajectory(T(c["poses0"]), T(c["rel"]), li, lj,
                                         lmeas, lmask,
                                         tc.PoseGraphConfig(**c["cfg"]))
        tol = PG_ROBUST_TOL
    else:
        graph = tpg.make_graph(T(c["rel"]), loop_i=li, loop_j=lj,
                               loop_meas=lmeas, loop_mask=lmask)
        single = tpg.optimize(T(c["poses0"]), graph, solver="banded",
                              band=10, max_iters=30, cost_rtol=1e-9)
        tol = PG_POSE_TOL
    jgot = _jax_pose_graph(name, c)
    assert got.poses.dtype == torch.float64
    for ref in (single, jgot):
        assert abs(got.iterations - int(ref.iterations)) <= 1
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses),
                                   atol=tol, rtol=0)
        assert abs(float(got.cost) - float(ref.cost)) <= max(
            PG_COST_RTOL * float(ref.cost), 1e-7)
    assert got.iterations > 1


@pytest.mark.parametrize("entry", ["optimize_sharded",
                                   "sharded_optimize_trajectory"])
def test_optimize_sharded_rejects_wide_arcs(ranked, entry):
    """A live arc wider than the band raises on both entry points, naming
    them; gated out, the same arc is fine."""
    msgs = dict(zip(["optimize_sharded", "sharded_optimize_trajectory"],
                    ranked["pg_wide"]))
    assert msgs[entry].startswith(f"{entry} is banded-only")
    assert "[10, 30]" in msgs[entry]
    assert bool(torch.isfinite(ranked["pg_wide_gated_out"].poses).all())


def test_loop_span_violation():
    """The one span check: live spans outside [0, band] come back as
    (min, max), gated-out ones and empty graphs as None."""
    li = torch.tensor([0, 10, 20])
    lj = torch.tensor([10, 25, 15])
    on = torch.tensor([True, True, True])
    assert tpg._loop_span_violation(li, lj, on, 10) == (-5, 15)
    assert tpg._loop_span_violation(li, lj, torch.tensor([True, False,
                                                          False]), 10) is None
    assert tpg._loop_span_violation(li[:0], lj[:0], on[:0], 10) is None
    assert tpg._loop_span_violation(li, lj, torch.zeros(3, dtype=torch.bool),
                                    10) is None
