"""The port's particle filters against the JAX package's, on the CPU.

The world is tests/test_particle_filter.py's (synthetic_dataset(240, 181,
seed=5), 0.1 m cells, 30 x 30 m, the known map built at ground truth), at
64 particles over the log's first 64 steps. Both packages are fed JAX's
own draws (the `noise` seam of the port's pf_step): no torch generator
reproduces JAX's stream.

Tolerances and their causes:
  - map_correlation: exact on a 0/1 map;
  - _score_particles: exact. The endpoints are float32 products: XLA's CPU
    fuses them into FMAs and takes its own float32 cos and sin, the port
    rounds cos and sin once from float64 (so that the card and the CPU
    agree), and the cell function is XLA's, x * (1/res)
    (tests/test_torch_host_utils.py). Only an endpoint within a float32
    spacing or two of a cell boundary could score the neighbouring cell;
    on failure the test counts such flips (none on this world);
  - pf_step from a JAX state carried across (utils/interop.carry_pf_state)
    on JAX's draws: at every step the port's scores equal JAX's own (read
    back from JAX's step), the particles and log-weights within 1e-5, the
    estimate within 1e-4, the resample flags equal;
  - whole runs: the localization and PF-SLAM tracks within 1e-4 with
    equal resample flags over all 64 steps, the PF-SLAM map within the
    online path's 1e-4 of JAX's with equal hit maps, and bit for bit the
    port's own build over its own track.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import occupancy as jocc
from lidar_slam_tpu.models import odometry as jodo
from lidar_slam_tpu.models import particle_filter as jpf
from lidar_slam_tpu.models import pf_slam as jps
from lidar_slam_tpu.ops import correlation as jcor
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.utils import io as jio

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.models import odometry as todo
from lidar_slam_tpu_torch.models import particle_filter as tpf
from lidar_slam_tpu_torch.models import pf_slam as tps
from lidar_slam_tpu_torch.ops import correlation as tcor
from lidar_slam_tpu_torch.utils import interop

torch.set_num_threads(1)

N, P = 64, 64
POSE_TOL, STATE_TOL, MAP_TOL = 1e-4, 1e-5, 1e-4
FLIP_SPACINGS = 8
MAP_KW = dict(resolution=0.1, world_max_x=15, world_min_x=-15,
              world_max_y=15, world_min_y=-15)
JMAP, TMAP = jc.MapConfig(**MAP_KW), tc.MapConfig(**MAP_KW)


@pytest.fixture(scope="module")
def world():
    d = jio.synthetic_dataset(n_steps=240, n_rays=181, seed=5)
    gt = np.asarray(d["ground_truth"], np.float32)
    counts = np.asarray(d["encoder"]["counts"], np.float32)
    gyro = np.asarray(d["imu"]["angular_velocity"], np.float32)
    pts, masks = jscan.scans_to_points(
        jnp.asarray(d["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
        jc.LidarConfig())
    pts = np.array(pts, np.float32)[..., :2]
    masks = np.array(masks)
    K = int(jocc.adaptive_ray_cells(pts, masks, JMAP, 30.0))
    lo = jocc.build_logodds(jnp.asarray(gt), jnp.asarray(pts),
                            jnp.asarray(masks), JMAP, K)
    im = np.asarray(lo > 0, np.float32)
    return dict(gt=gt, counts=counts, gyro=gyro, pts=pts, masks=masks, K=K,
                im=im)


def _jax_noise(key, n, p):
    """The draws JAX's pf_step makes over n - 1 steps from `key`, stacked:
    (eps_v (n-1, p), eps_w (n-1, p), u (n-1,))."""
    ev, ew, us = [], [], []
    for _ in range(1, n):
        key, k_v, k_w, k_u = jax.random.split(key, 4)
        ev.append(np.asarray(jax.random.normal(k_v, (p,), jnp.float32)))
        ew.append(np.asarray(jax.random.normal(k_w, (p,), jnp.float32)))
        us.append(np.asarray(jax.random.uniform(k_u, (), jnp.float32)))
    return np.stack(ev), np.stack(ew), np.stack(us)


@jax.jit
def _jax_world_points(particles, pts):
    """JAX's _score_particles endpoints, op for op."""
    c = jnp.cos(particles[:, 2])[:, None]
    s = jnp.sin(particles[:, 2])[:, None]
    xw = c * pts[None, :, 0] - s * pts[None, :, 1] + particles[:, 0:1]
    yw = s * pts[None, :, 0] + c * pts[None, :, 1] + particles[:, 1:2]
    return xw, yw


def _port_world_points(particles, pts):
    """The port's _score_particles endpoints, op for op."""
    c, s = (v[:, None] for v in tpf._cos_sin(particles[:, 2]))
    return (c * pts[None, :, 0] - s * pts[None, :, 1] + particles[:, 0:1],
            s * pts[None, :, 0] + c * pts[None, :, 1] + particles[:, 1:2])


def _flipped_endpoints(particles, pts, mask):
    """(flipped, near): the endpoints whose cell differs between the
    packages on the same particles, and how many of them lie within
    FLIP_SPACINGS float32 spacings of a cell boundary."""
    xj, yj = (np.asarray(a) for a in _jax_world_points(
        jnp.asarray(particles), jnp.asarray(pts)))
    xt, yt = (a.numpy() for a in _port_world_points(
        torch.as_tensor(particles), torch.as_tensor(pts)))
    cj = [np.asarray(c) for c in jocc.world2grid(jnp.asarray(xj),
                                                 jnp.asarray(yj), JMAP)]
    ct = [c.numpy() for c in tocc.world2grid(torch.as_tensor(xt),
                                             torch.as_tensor(yt), TMAP)]
    flipped = near = 0
    for a, b, wt, lo_edge in ((cj[0], ct[0], xt, JMAP.world_min_x),
                              (cj[1], ct[1], yt, JMAP.world_min_y)):
        diff = (a != b) & mask[None, :]
        flipped += int(diff.sum())
        w = wt[diff].astype(np.float64)
        edge = lo_edge + np.round((w - lo_edge) / JMAP.resolution) \
            * JMAP.resolution
        gap = np.abs(w - edge) / np.spacing(np.abs(wt[diff]))
        near += int((gap <= FLIP_SPACINGS).sum())
    return flipped, near


def _biased(world):
    return world["counts"] * np.float32(1.15)


# ---------------------------------------------------------------- correlation

def test_map_correlation_matches_jax():
    """The reference's 9 x 9 offset grid over a random 0/1 map, one scan
    and a batch of four, float32 and float64 maps: equal to JAX's."""
    rng = np.random.default_rng(0)
    im = (rng.random((61, 53)) > 0.7).astype(np.float32)
    x_im = np.linspace(-3.0, 3.0, 61).astype(np.float32)
    y_im = np.linspace(-2.6, 2.6, 53).astype(np.float32)
    vp = rng.uniform(-3.2, 3.2, (4, 2, 200)).astype(np.float32)
    xs = (np.arange(-4, 5) * 0.05).astype(np.float32)
    ys = (np.arange(-4, 5) * 0.05).astype(np.float32)
    t = [torch.as_tensor(a) for a in (x_im, y_im)]
    for dt in (np.float32, np.float64):
        j1 = np.asarray(jcor.map_correlation(
            jnp.asarray(im.astype(dt)), jnp.asarray(x_im), jnp.asarray(y_im),
            jnp.asarray(vp[0]), jnp.asarray(xs), jnp.asarray(ys)))
        t1 = tcor.map_correlation(torch.as_tensor(im.astype(dt)), *t,
                                  torch.as_tensor(vp[0]), torch.as_tensor(xs),
                                  torch.as_tensor(ys))
        jb = np.asarray(jcor.map_correlation_batch(
            jnp.asarray(im.astype(dt)), jnp.asarray(x_im), jnp.asarray(y_im),
            jnp.asarray(vp), jnp.asarray(xs), jnp.asarray(ys)))
        tb = tcor.map_correlation_batch(
            torch.as_tensor(im.astype(dt)), *t, torch.as_tensor(vp),
            torch.as_tensor(xs), torch.as_tensor(ys))
        assert t1.dtype == (torch.float64 if dt is np.float64
                            else torch.float32)
        assert t1.shape == (9, 9) and tb.shape == (4, 9, 9)
        np.testing.assert_array_equal(t1.numpy(), j1)
        np.testing.assert_array_equal(tb.numpy(), jb)
        assert j1.max() > 20  # the scan really hits the map


# -------------------------------------------------------------------- scoring

def test_score_particles_flips_are_cell_boundaries(world):
    """Scores of 64 particles around every 8th ground-truth pose (4 at
    the pose itself): equal to JAX's."""
    rng = np.random.default_rng(1)
    im = torch.as_tensor(world["im"])
    scores = differ = flipped = near = 0
    for k in range(0, 240, 8):
        parts = (world["gt"][k][None] + rng.normal(
            0, [0.05, 0.05, 0.02], (P, 3))).astype(np.float32)
        parts[:4] = world["gt"][k]
        pts, mask = world["pts"][k], world["masks"][k]
        js = np.asarray(jpf._score_particles(
            jnp.asarray(parts), jnp.asarray(pts), jnp.asarray(mask),
            jnp.asarray(world["im"]), JMAP))
        ts = tpf._score_particles(torch.as_tensor(parts),
                                  torch.as_tensor(pts),
                                  torch.as_tensor(mask), im, TMAP).numpy()
        scores += P
        differ += int((js != ts).sum())
        f, nr = _flipped_endpoints(parts, pts, mask)
        flipped += f
        near += nr
    # on failure: how many endpoints flipped, and how many of them lie at
    # a cell boundary
    assert differ == 0, (differ, flipped, near)
    assert scores == 30 * P


def test_score_consistent_with_map_builder():
    """A scan scored at the pose it was painted from hits every endpoint
    cell: the score equals the ray count (tests/test_particle_filter.py)."""
    cfg = tc.MapConfig(resolution=0.1, world_max_x=10, world_min_x=-10,
                       world_max_y=10, world_min_y=-10)
    R = 16
    ang = np.linspace(0, 2 * np.pi, R, endpoint=False)
    r = np.linspace(2.0, 5.0, R)
    pts = torch.as_tensor(np.stack([r * np.cos(ang), r * np.sin(ang)], -1),
                          dtype=torch.float32)
    pose = torch.tensor([0.3, -0.2, 0.4])
    mask = torch.ones(R, dtype=torch.bool)
    K = tocc.adaptive_ray_cells(pts[None], mask[None], cfg, 30.0)
    im = (tocc.build_logodds(pose[None], pts[None], mask[None], cfg, K)
          > 0).float()
    assert int(im.sum()) == R
    assert float(tpf._score_particles(pose[None], pts, mask, im, cfg)[0]) == R


# -------------------------------------------------------------- filter links

@pytest.mark.parametrize("u", [0.0, 0.37, 0.999])
def test_systematic_resample_properties(u):
    """Each particle drawn floor(P w) or ceil(P w) times, deterministic in
    u, and the same indices as JAX's (searchsorted's left side)."""
    particles = torch.arange(8, dtype=torch.float32)[:, None].expand(8, 3)
    w = torch.tensor([0.4, 0.2, 0.1, 0.1, 0.1, 0.05, 0.03, 0.02])
    out = tpf._systematic_resample(particles, w, torch.tensor(u))[:, 0]
    counts = np.bincount(out.numpy().astype(int), minlength=8)
    for i in range(8):
        assert (np.floor(8 * float(w[i])) <= counts[i]
                <= np.ceil(8 * float(w[i])))
    assert torch.equal(out, tpf._systematic_resample(
        particles, w, torch.tensor(u))[:, 0])
    j = jpf._systematic_resample(jnp.asarray(particles.numpy()),
                                 jnp.asarray(w.numpy()), jnp.float32(u))
    np.testing.assert_array_equal(np.asarray(j)[:, 0], out.numpy())
    rng = np.random.default_rng(2)
    w64 = rng.random(64).astype(np.float32)
    w64 /= w64.sum()
    p64 = torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(jpf._systematic_resample(jnp.asarray(p64.numpy()),
                                            jnp.asarray(w64),
                                            jnp.float32(u))),
        tpf._systematic_resample(p64, torch.as_tensor(w64),
                                 torch.tensor(u)).numpy())


def test_pf_step_from_carried_jax_state(world):
    """Every step of JAX's localization run, replayed by the port from JAX's
    own state (carried with interop.carry_pf_state) and draws. JAX's own
    scores inside its fused step are read back from the same step with
    resampling off (its log-weights minus the carried ones, over the
    temperature): the port's equal them at every step."""
    import dataclasses

    counts, gyro, pts, masks = (_biased(world), world["gyro"], world["pts"],
                                world["masks"])
    cfg, tcfg = jpf.PFConfig(n_particles=P), tpf.PFConfig(n_particles=P)
    cfg_keep = dataclasses.replace(cfg, resample_frac=0.0)
    key = jax.random.PRNGKey(3)
    noise = _jax_noise(key, N, P)
    im_j, im_t = jnp.asarray(world["im"]), torch.as_tensor(world["im"])
    v_all = np.asarray(jodo.v_from_encoder(jnp.asarray(counts)))
    st = jpf.init_pf_state(cfg, jnp.asarray(world["gt"][0]), key)
    flips = []
    for t in range(1, N):
        gen = torch.Generator()
        tst = interop.carry_pf_state(st, gen)
        args = (v_all[t], jnp.float32(gyro[t, -1]), jnp.asarray(pts[t]),
                jnp.asarray(masks[t]), im_j, JMAP)
        new, (est, neff, rs) = jpf.pf_step(st, *args, cfg)
        kept, _ = jpf.pf_step(st, *args, cfg_keep)
        nz = tuple(torch.as_tensor(a[t - 1]) for a in noise)
        gstate = gen.get_state()
        tnew, (test, tneff, trs) = tpf.pf_step(
            tst, torch.tensor(v_all[t]), torch.tensor(gyro[t, -1]),
            torch.as_tensor(pts[t]), torch.as_tensor(masks[t]), im_t, TMAP,
            tcfg, noise=nz)
        assert torch.equal(gen.get_state(), gstate)  # noise given: untouched
        tpred = tpf._predict_particles(tst.particles, torch.tensor(v_all[t]),
                                       torch.tensor(gyro[t, -1]), nz[0],
                                       nz[1], tcfg)
        np.testing.assert_allclose(tpred.numpy(), np.asarray(kept.particles),
                                   atol=STATE_TOL)
        ts = tpf._score_particles(tpred, torch.as_tensor(pts[t]),
                                  torch.as_tensor(masks[t]), im_t,
                                  TMAP).numpy()
        js = (np.asarray(kept.logw, np.float64)
              - np.asarray(st.logw, np.float64)) / cfg.temperature
        resid = js - ts
        assert np.abs(resid - np.median(resid)).max() < 1e-2, t
        np.testing.assert_allclose(test.numpy(), np.asarray(est),
                                   atol=POSE_TOL)
        assert bool(trs) == bool(rs), t
        np.testing.assert_allclose(tnew.particles.numpy(),
                                   np.asarray(new.particles), atol=STATE_TOL)
        np.testing.assert_allclose(tnew.logw.numpy(), np.asarray(new.logw),
                                   atol=STATE_TOL)
        np.testing.assert_allclose(float(tneff), float(neff),
                                   rtol=STATE_TOL)
        st = new


def _pos_err(poses, gt):
    return np.linalg.norm(np.asarray(poses)[:, :2] - gt[:, :2], axis=1)


def test_localize_run_fed_jax_noise(world):
    """localize_particle_filter over 64 steps from a 15% encoder bias,
    both packages on JAX's draws: tracks within 1e-4 with equal resample
    flags, and a mean error below dead reckoning's."""
    counts, gyro, pts, masks, gt = (_biased(world), world["gyro"],
                                    world["pts"], world["masks"], world["gt"])
    key = jax.random.PRNGKey(3)
    jp, jaux = jpf.localize_particle_filter(
        jnp.asarray(world["im"]), jnp.asarray(counts[:N]),
        jnp.asarray(gyro[:N]), jnp.asarray(pts[:N]), jnp.asarray(masks[:N]),
        JMAP, jpf.PFConfig(n_particles=P), x0=jnp.asarray(gt[0]), key=key)
    tp, taux = tpf.localize_particle_filter(
        world["im"], counts[:N], gyro[:N], pts[:N], masks[:N], TMAP,
        tpf.PFConfig(n_particles=P), x0=gt[0], noise=_jax_noise(key, N, P),
        device="cpu")
    assert tp.shape == (N, 3) and torch.isfinite(tp).all()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=POSE_TOL)
    np.testing.assert_array_equal(taux["resampled"].numpy(),
                                  np.asarray(jaux["resampled"]))
    assert bool(taux["resampled"].any())
    odo = todo.poses_from_odometry(torch.as_tensor(counts[:N]),
                                   torch.as_tensor(gyro[:N]),
                                   x_0=torch.as_tensor(gt[0]))
    err_t = _pos_err(tp.numpy(), gt[:N])
    assert err_t.mean() < _pos_err(odo.numpy(), gt[:N]).mean()


def test_slam_run_fed_jax_noise(world):
    """slam_particle_filter over 64 steps from a 15% encoder bias, no prior
    map, both packages on JAX's draws: tracks within 1e-4 with equal
    resample flags, the map within the online path's 1e-4 of JAX's with
    equal hit maps, and bit for bit the port's own build over its track."""
    counts, gyro, pts, masks, gt, K = (_biased(world), world["gyro"],
                                       world["pts"], world["masks"],
                                       world["gt"], world["K"])
    key = jax.random.PRNGKey(3)
    jp, jlo, jaux = jps.slam_particle_filter(
        jnp.asarray(counts[:N]), jnp.asarray(gyro[:N]), jnp.asarray(pts[:N]),
        jnp.asarray(masks[:N]), JMAP, jpf.PFConfig(n_particles=P),
        x0=jnp.asarray(gt[0]), key=key, K=K)
    tp, tlo, taux = tps.slam_particle_filter(
        counts[:N], gyro[:N], pts[:N], masks[:N], TMAP,
        tpf.PFConfig(n_particles=P), x0=gt[0], noise=_jax_noise(key, N, P),
        K=K, device="cpu")
    assert torch.isfinite(tp).all() and bool(taux["resampled"].any())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=POSE_TOL)
    np.testing.assert_array_equal(taux["resampled"].numpy(),
                                  np.asarray(jaux["resampled"]))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), atol=MAP_TOL)
    np.testing.assert_array_equal(tlo.numpy() > 0, np.asarray(jlo) > 0)
    rebuilt = tocc.build_logodds(tp, torch.as_tensor(pts[:N]),
                                 torch.as_tensor(masks[:N]), TMAP, K)
    assert torch.equal(tlo, rebuilt)
    assert int((tlo > 0).sum()) > 100  # it really mapped


# ------------------------------------------------------------- the port alone

@pytest.mark.parametrize("which", ["localize", "slam"])
def test_zero_noise_equals_dead_reckoning(world, which):
    """sigma = 0, temperature = 0: every particle is the dead-reckoned
    pose, so the track equals poses_from_odometry, and no step resamples."""
    counts, gyro, pts, masks, gt = (world["counts"], world["gyro"],
                                    world["pts"], world["masks"], world["gt"])
    cfg = tpf.PFConfig(n_particles=8, sigma_v=0.0, sigma_w=0.0,
                       temperature=0.0)
    if which == "localize":
        poses, aux = tpf.localize_particle_filter(
            world["im"], counts, gyro, pts, masks, TMAP, cfg, device="cpu")
        odo = todo.poses_from_odometry(torch.as_tensor(counts),
                                       torch.as_tensor(gyro))
    else:
        poses, _, aux = tps.slam_particle_filter(
            counts[:N], gyro[:N], pts[:N], masks[:N], TMAP, cfg, x0=gt[0],
            K=world["K"], device="cpu")
        odo = todo.poses_from_odometry(torch.as_tensor(counts[:N]),
                                       torch.as_tensor(gyro[:N]),
                                       x_0=torch.as_tensor(gt[0]))
    np.testing.assert_allclose(poses.numpy(), odo.numpy(), atol=1e-5)
    assert not bool(aux["resampled"].any())


def test_streaming_equals_batch_and_generator_stream(world):
    """pf_step and pf_slam_step streamed one scan at a time equal the batch
    entries bit for bit on one seeded generator; a seed fixes the stream."""
    counts, gyro, pts, masks, gt, K = (world["counts"], world["gyro"],
                                       world["pts"], world["masks"],
                                       world["gt"], world["K"])
    n, cfg = 24, tpf.PFConfig(n_particles=32)
    im = torch.as_tensor(world["im"])
    batch, _ = tpf.localize_particle_filter(im, counts[:n], gyro[:n],
                                            pts[:n], masks[:n], TMAP, cfg,
                                            seed=7, device="cpu")
    again, _ = tpf.localize_particle_filter(im, counts[:n], gyro[:n],
                                            pts[:n], masks[:n], TMAP, cfg,
                                            seed=7, device="cpu")
    other, _ = tpf.localize_particle_filter(im, counts[:n], gyro[:n],
                                            pts[:n], masks[:n], TMAP, cfg,
                                            seed=8, device="cpu")
    assert torch.equal(batch, again) and not torch.equal(batch, other)
    st = tpf.init_pf_state(cfg, seed=7, device="cpu")
    v_all = todo.v_from_encoder(torch.as_tensor(counts[:n]))
    track = [torch.zeros(3)]
    for t in range(1, n):
        st, (est, _, _) = tpf.pf_step(st, v_all[t],
                                      torch.tensor(gyro[t, -1]),
                                      torch.as_tensor(pts[t]),
                                      torch.as_tensor(masks[t]), im, TMAP,
                                      cfg)
        track.append(est)
    assert torch.equal(torch.stack(track), batch)

    b_poses, b_lo, _ = tps.slam_particle_filter(
        counts[:n], gyro[:n], pts[:n], masks[:n], TMAP, cfg, x0=gt[0], K=K,
        seed=5, device="cpu")
    s = tps.init_pf_slam(pts[0], masks[0], TMAP, cfg, x0=gt[0], K=K, seed=5,
                         device="cpu")
    ests = [torch.as_tensor(gt[0])]
    for t in range(1, n):
        s, (est, _, _) = tps.pf_slam_step(
            s, torch.as_tensor(counts[t]), torch.as_tensor(gyro[t]),
            torch.as_tensor(pts[t]), torch.as_tensor(masks[t]), TMAP, cfg, K)
        ests.append(est)
    assert torch.equal(torch.stack(ests), b_poses)
    assert torch.equal(s.logodds, b_lo) and int(s.step) == n


def test_carry_pf_slam_state(world):
    """A JAX PFSlamState carried across keeps every array, the generator
    is the one passed, and a port step from it continues JAX's step within
    the tolerances above."""
    pts, masks, gt, K = (world["pts"], world["masks"], world["gt"],
                         world["K"])
    cfg = jpf.PFConfig(n_particles=P)
    key = jax.random.PRNGKey(4)
    js = jps.init_pf_slam(jnp.asarray(pts[0]), jnp.asarray(masks[0]), JMAP,
                          cfg, x0=jnp.asarray(gt[0]), key=key, K=K)
    gen = torch.Generator()
    ts = interop.carry_pf_state(js, gen)
    lo0 = np.array(js.logodds)  # pf_slam_step donates js
    assert isinstance(ts, tps.PFSlamState) and ts.generator is gen
    for name in ("particles", "logw", "logodds", "step"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    with pytest.raises(ValueError):
        interop.carry_pf_state(js, gen, device="meta")
    # a port paint of scan 0 equals JAX's
    t0 = tps.init_pf_slam(pts[0], masks[0], TMAP, tpf.PFConfig(n_particles=P),
                          x0=gt[0], K=K, device="cpu")
    np.testing.assert_allclose(t0.logodds.numpy(), np.asarray(js.logodds),
                               atol=MAP_TOL)
    noise = _jax_noise(key, 2, P)
    jnew, (jest, _, jrs) = jps.pf_slam_step(
        js, jnp.asarray(world["counts"][1]), jnp.asarray(world["gyro"][1]),
        jnp.asarray(pts[1]), jnp.asarray(masks[1]), JMAP, cfg, K)
    tnew, (test, _, trs) = tps.pf_slam_step(
        ts, torch.as_tensor(world["counts"][1]),
        torch.as_tensor(world["gyro"][1]), torch.as_tensor(pts[1]),
        torch.as_tensor(masks[1]), TMAP, tpf.PFConfig(n_particles=P), K,
        noise=tuple(torch.as_tensor(a[0]) for a in noise))
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=POSE_TOL)
    assert bool(trs) == bool(jrs)
    # the paint at the port's estimate equals JAX's paint at it
    jpaint = np.asarray(jocc.build_logodds(
        jnp.asarray(test.numpy())[None], jnp.asarray(pts[1])[None],
        jnp.asarray(masks[1])[None], JMAP, K, init=jnp.asarray(lo0)))
    np.testing.assert_allclose(tnew.logodds.numpy(), jpaint, atol=MAP_TOL)
    np.testing.assert_array_equal(tnew.logodds.numpy() > 0, jpaint > 0)
    assert int(tnew.step) == int(jnew.step) == 2
