"""The port's global relocalization against the JAX package's, on the CPU.

The world is tests/test_relocalization.py's (synthetic_dataset(160, 541,
seed=3), 0.1 m cells, 32 x 32 m, the map built at ground truth) at its
configurations. Node scores are integer sums, so once both packages
search from the same base cells (each yaw sample's subsampled endpoint
cells) every score, the beam's order (ties included), the certificate and
the grid pose are equal exactly: the port's search runs here from JAX's
base cells. The base cells themselves are held equal except endpoints at a
cell boundary (XLA's CPU rounds its float32 cos, sin and fused products
apart from the port, which rounds cos and sin once from float64 so that
the card and the CPU agree), which are counted and shown to lie within a few float32 spacings
of it. The polish (relocalize_refined) is held within 1e-4, and the
online recovery (relocalize_and_reseed) on a shortened copy of
tests/test_online.py's kidnap log: the loss gate fires at the same step in
both packages, and the recovered poses agree within 1e-3
(SMALL_POSE_TOL of chip_smoke.py).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import occupancy as jocc
from lidar_slam_tpu.models import online as jon
from lidar_slam_tpu.models import relocalization as jrl
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.utils import io as jio

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import online as ton
from lidar_slam_tpu_torch.models import relocalization as trl
from lidar_slam_tpu_torch.utils import io as tio
from lidar_slam_tpu_torch.utils.precision import in_float64

torch.set_num_threads(1)

REFINE_TOL, RESEED_TOL = 1e-4, 1e-3
FLIP_SPACINGS = 8
MAP_KW = dict(world_max_x=16.0, world_min_x=-16.0, world_max_y=16.0,
              world_min_y=-16.0, resolution=0.1)
JMAP, TMAP = jc.MapConfig(**MAP_KW), tc.MapConfig(**MAP_KW)
# tests/test_relocalization.py's configurations: (scan, config)
CONFIGS = {
    "certified": (80, dict(n_angles=24, search_radius=2.0, n_levels=3,
                           beam=256, max_rays=96, score_chunk=4096)),
    "beam2": (40, dict(n_angles=16, search_radius=1.6, n_levels=3, beam=2,
                       max_rays=64, score_chunk=4096)),
    "beam8": (40, dict(n_angles=16, search_radius=1.6, n_levels=3, beam=8,
                       max_rays=64, score_chunk=4096)),
    "kidnapped": (30, dict(n_angles=72, search_radius=5.0, n_levels=4,
                           beam=512, max_rays=128)),
}


@pytest.fixture(scope="module")
def world():
    ds = jio.synthetic_dataset(n_steps=160, n_rays=541, seed=3)
    gt = np.asarray(ds["ground_truth"], np.float32)
    pts, mask = jscan.scans_to_points(
        jnp.asarray(ds["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
        jc.LidarConfig())
    pts = np.array(pts, np.float32)[..., :2]
    mask = np.array(mask)
    K = jocc.max_ray_cells(JMAP, 30.0)
    lo = np.array(jocc.build_logodds(jnp.asarray(gt), jnp.asarray(pts),
                                     jnp.asarray(mask), JMAP, K,
                                     backend="scatter"))
    return dict(gt=gt, pts=pts, mask=mask, lo=lo)


def _center(world, k, name):
    return ((0.0, 0.0) if name == "kidnapped"
            else (float(world["gt"][k, 0]), float(world["gt"][k, 1])))


def _base_pair(world, k, jcfg, center):
    """(JAX's base cells as numpy, the port's as tensors)."""
    jb = jrl._base_cells(jnp.asarray(world["pts"][k]),
                         jnp.asarray(world["mask"][k]),
                         jnp.asarray(center, jnp.float32),
                         trl._angles(jcfg), JMAP, jcfg.max_rays)
    tb = trl._base_cells(torch.as_tensor(world["pts"][k]),
                         torch.as_tensor(world["mask"][k]),
                         torch.tensor(center, dtype=torch.float32),
                         trl._angles(jcfg), TMAP, jcfg.max_rays)
    return tuple(np.array(a) for a in jb), tb


def test_max_pyramid_matches_jax():
    """Bit for bit on a random 0/1 map and on raw values (clamped at 0)."""
    rng = np.random.default_rng(0)
    for im in ((rng.random((37, 29)) > 0.8).astype(np.float32),
               rng.normal(size=(33, 41)).astype(np.float32)):
        jl = jrl.build_max_pyramid(jnp.asarray(im), 5)
        tl = trl.build_max_pyramid(torch.as_tensor(im), 5)
        assert len(tl) == 5
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_base_cells_flips_are_cell_boundaries(world, name):
    """The base cells equal JAX's."""
    k, kw = CONFIGS[name]
    cfg = trl.RelocConfig(**kw)
    center = _center(world, k, name)
    (ji, jj, jm), (ti, tj, tm) = _base_pair(world, k, cfg, center)
    np.testing.assert_array_equal(tm.numpy(), jm)
    # the port's world-frame endpoints, recomputed in float64 from its
    # float32 ops, against each boundary
    stride = max(1, -(-world["pts"].shape[1] // cfg.max_rays))
    p = torch.as_tensor(world["pts"][k][::stride])
    th = torch.as_tensor(trl._angles(cfg), dtype=torch.float32)
    c, s = (in_float64(f, th)[:, None] for f in (torch.cos, torch.sin))
    xw = (c * p[None, :, 0] - s * p[None, :, 1] + center[0]).numpy()
    yw = (s * p[None, :, 0] + c * p[None, :, 1] + center[1]).numpy()
    flipped = near = 0
    for a, b, w, lo_edge in ((ji, ti.numpy(), xw, JMAP.world_min_x),
                             (jj, tj.numpy(), yw, JMAP.world_min_y)):
        diff = (a != b) & jm[None, :]
        flipped += int(diff.sum())
        w64 = w[diff].astype(np.float64)
        edge = lo_edge + np.round((w64 - lo_edge) / JMAP.resolution) \
            * JMAP.resolution
        near += int((np.abs(w64 - edge)
                     <= FLIP_SPACINGS * np.spacing(np.abs(w[diff]))).sum())
    # on failure: how many cells flipped, and how many of them lie at a
    # cell boundary
    assert flipped == 0, (flipped, near)


@pytest.mark.parametrize("leaf", [False, True])
def test_score_nodes_matches_jax(world, leaf):
    """Random nodes (dead ones, offsets past every map edge, a chunk that
    does not divide the count) scored on JAX's base cells: equal."""
    cfg = trl.RelocConfig(**CONFIGS["certified"][1])
    (bi, bj, bm), _ = _base_pair(world, 80, cfg, _center(world, 80,
                                                        "certified"))
    rng = np.random.default_rng(3)
    n = 5000
    ai = rng.integers(0, cfg.n_angles, n).astype(np.int32)
    oi = rng.integers(-200, 200, n).astype(np.int32)
    oj = rng.integers(-200, 200, n).astype(np.int32)
    live = rng.random(n) > 0.1
    im = trl.hit_map(torch.as_tensor(world["lo"]))
    for level, pool in enumerate(trl.build_max_pyramid(im, 3)):
        js = jrl._score_nodes(jnp.asarray(pool.numpy()), jnp.asarray(bi),
                              jnp.asarray(bj), jnp.asarray(bm),
                              jnp.asarray(ai), jnp.asarray(oi),
                              jnp.asarray(oj), jnp.asarray(live), leaf=leaf,
                              chunk=1536)
        ts = trl._score_nodes(pool, *(torch.as_tensor(a) for a in (
            bi, bj, bm, ai, oi, oj, live)), leaf=leaf, chunk=1536)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert np.isinf(ts.numpy()).sum() == (~live).sum()


@pytest.mark.parametrize("k", [3, 100, 400])
def test_keep_top_ties_in_index_order(k):
    """Integer scores full of ties and -inf: the kept nodes, their order
    and the best dropped score equal jax.lax.top_k's."""
    rng = np.random.default_rng(k)
    n = 1000
    scores = rng.integers(0, 12, n).astype(np.float32)
    scores[rng.random(n) < 0.2] = -np.inf
    ai, oi, oj = (rng.integers(-50, 50, n).astype(np.int32)
                  for _ in range(3))
    j = jrl._keep_top(jnp.asarray(scores), jnp.asarray(ai), jnp.asarray(oi),
                      jnp.asarray(oj), k)
    t = trl._keep_top(torch.as_tensor(scores), torch.as_tensor(ai),
                      torch.as_tensor(oi), torch.as_tensor(oj), k)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    small = trl._keep_top(torch.as_tensor(scores[:k]), *(
        torch.as_tensor(a[:k]) for a in (ai, oi, oj)), k)
    assert np.isneginf(float(small[-1]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_search_equals_jax_from_its_base_cells(world, name):
    """The port's search from JAX's base cells: the grid pose, score,
    certificate, margin and every leaf equal JAX's relocalize."""
    k, kw = CONFIGS[name]
    jcfg, tcfg = jrl.RelocConfig(**kw), trl.RelocConfig(**kw)
    center = _center(world, k, name)
    jres, jleaves = jrl.relocalize(
        jrl.hit_map(jnp.asarray(world["lo"])), JMAP,
        jnp.asarray(world["pts"][k]), jnp.asarray(world["mask"][k]), jcfg,
        center=center, return_leaves=True)
    jbase, _ = _base_pair(world, k, tcfg, center)
    tres, tleaves = trl.search(trl.hit_map(torch.as_tensor(world["lo"])),
                               TMAP, tuple(torch.as_tensor(a)
                                           for a in jbase),
                               tcfg, center, return_leaves=True)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if name in ("certified", "kidnapped"):
        assert bool(tres.certified)
    # the port's own relocalize, on its own base cells, is the same search
    own = trl.relocalize(trl.hit_map(torch.as_tensor(world["lo"])), TMAP,
                         torch.as_tensor(world["pts"][k]),
                         torch.as_tensor(world["mask"][k]), tcfg, center)
    _, tbase = _base_pair(world, k, tcfg, center)
    if all(np.array_equal(a, b.numpy()) for a, b in zip(jbase, tbase)):
        for a, b in zip(jres, own):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_top_candidates_and_occupied_points_equal(world):
    """The host-side helpers on the same leaves and map: equal arrays."""
    k, kw = CONFIGS["kidnapped"]
    cfg = jrl.RelocConfig(**kw)
    _, leaves = jrl.relocalize(jrl.hit_map(jnp.asarray(world["lo"])), JMAP,
                               jnp.asarray(world["pts"][k]),
                               jnp.asarray(world["mask"][k]), cfg,
                               return_leaves=True)
    angles = trl._angles(cfg)
    for n_best in (1, 4, 8):
        jp, js = jrl.top_candidates(leaves, angles, (0.0, 0.0), JMAP, n_best)
        tp, ts = trl.top_candidates(
            tuple(torch.as_tensor(np.asarray(a)) for a in leaves), angles,
            (0.0, 0.0), TMAP, n_best)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)
    for kw2 in (dict(max_pts=128), dict(max_pts=4096),
                dict(max_pts=512, center=(1.0, -2.0), radius=6.0)):
        ja, jm = jrl.occupied_points(world["lo"], JMAP, **kw2)
        ta, tm = trl.occupied_points(torch.as_tensor(world["lo"]), TMAP,
                                     **kw2)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("n_candidates", [1, 4])
def test_relocalize_refined_within_tolerance(world, n_candidates):
    """Grid search + ICP polish from any heading (the kidnapped config):
    the refined pose within 1e-4 of JAX's, the grid result equal, and both
    within 1.2 cells of ground truth."""
    k, kw = CONFIGS["kidnapped"]
    jg, jr, je = jrl.relocalize_refined(
        jnp.asarray(world["lo"]), JMAP, jnp.asarray(world["pts"][k]),
        jnp.asarray(world["mask"][k]), jrl.RelocConfig(**kw),
        center=(0.0, 0.0), n_candidates=n_candidates)
    tg, tr, te = trl.relocalize_refined(
        torch.as_tensor(world["lo"]), TMAP, torch.as_tensor(world["pts"][k]),
        torch.as_tensor(world["mask"][k]), trl.RelocConfig(**kw),
        center=(0.0, 0.0), n_candidates=n_candidates)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=REFINE_TOL)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-3, atol=1e-7)
    gt = world["gt"][k]
    assert np.hypot(*(tr.numpy()[:2] - gt[:2])) <= 1.2 * TMAP.resolution
    assert float(te) < 1e-3


def test_relocalize_and_reseed_on_kidnap_log():
    """tests/test_online.py's kidnap at 160 steps (kidnap at step 120 back
    to step 30's pose), PLICP tracking, loss gate at 0.3 m: the gate fires
    at the kidnap step only, in both packages; the recovered poses agree
    within 1e-3 and lie within 5 cm and 0.03 rad of ground truth; the
    re-seeded ring-buffer slot and the painted map agree too."""
    n, t_kidnap = 160, 120
    counts, gyro, ranges, gt2 = tio.kidnap_log(n, t_kidnap, 30)
    mk = dict(resolution=0.1, world_min_x=-15.0, world_max_x=15.0,
              world_min_y=-15.0, world_max_y=15.0)
    cfgs = []
    for C in (jc, tc):
        base = C.SlamConfig()
        cfgs.append(dataclasses.replace(
            base, map=C.MapConfig(**mk),
            icp=dataclasses.replace(base.icp, metric="point_to_line"),
            online=C.OnlineConfig(loss_rms_thresh=0.3)))
    jcfg, tcfg = cfgs
    pts, masks = jscan.scans_to_points(jnp.asarray(ranges, jnp.float32), 0.1,
                                       30.0, jcfg.lidar)
    pts, masks = np.array(pts, np.float32), np.array(masks)
    counts, gyro = counts.astype(np.float32), gyro.astype(np.float32)
    k = jon.default_ray_cells(jcfg, 30.0)
    jst = jon.init_state(jnp.asarray(pts[0]), jnp.asarray(masks[0]), jcfg,
                         n_max=256, K=k)
    tst = ton.init_state(pts[0], masks[0], tcfg, n_max=256, K=k,
                         device="cpu")
    fired = {"jax": [], "port": []}
    for t in range(1, n):
        jst = jon.online_step(jst, jnp.asarray(counts[t]),
                              jnp.asarray(gyro[t]), jnp.asarray(pts[t]),
                              jnp.asarray(masks[t]), jcfg, K=k)
        tst = ton.online_step(tst, counts[t], gyro[t], pts[t], masks[t],
                              tcfg, K=k)
        if float(jst.match_rms) > 0.3:
            fired["jax"].append(t)
            jst, jg, _ = jon.relocalize_and_reseed(jst, jcfg, K=k)
        if float(tst.match_rms) > 0.3:
            fired["port"].append(t)
            tst, tg, _ = ton.relocalize_and_reseed(tst, tcfg, K=k)
            err = tst.pose.numpy() - gt2[t]
            assert np.hypot(err[0], err[1]) < 0.05
            assert abs((err[2] + np.pi) % (2 * np.pi) - np.pi) < 0.03
            assert float(tst.match_rms) == 0.0
            np.testing.assert_allclose(tst.pose.numpy(), np.asarray(jst.pose),
                                       atol=RESEED_TOL)
            np.testing.assert_allclose(tst.rel_hist[t].numpy(),
                                       np.asarray(jst.rel_hist[t]),
                                       atol=RESEED_TOL)
            np.testing.assert_array_equal(tst.logodds.numpy() > 0,
                                          np.asarray(jst.logodds) > 0)
    assert fired["port"] == fired["jax"] == [t_kidnap]
    np.testing.assert_allclose(tst.pose.numpy(), np.asarray(jst.pose),
                               atol=RESEED_TOL)
    assert np.hypot(*(tst.pose.numpy()[:2] - gt2[-1, :2])) < 0.15
