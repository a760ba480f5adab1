"""Particle-filter localization against a known occupancy map.

Counterpart of lidar_slam_tpu/models/particle_filter.py, the filter the
course starter's mapCorrelation was shipped for (reference
code/pr2_utils.py:12-43). Each step is vectorized over particles: the
sinc diff-drive motion sample (reference modules/localization.py:15-36),
the map-correlation score of the scan at every particle pose, a weighted
estimate, and a BRANCHLESS systematic resample (the resampled cloud is
always computed and selected by torch.where on the effective-sample-size
test), so a step reads nothing back to the host.

The JAX package carries a PRNG key; here the state carries a
torch.Generator on the state's device. No torch generator reproduces
JAX's stream, so pf_step also takes the step's noise explicitly (`noise`),
and the batch entry takes it stacked over steps: with it, the generator is
not touched. The batch entry is a Python loop over pf_step (JAX's is a
lax.scan over it), so streaming and batch tracks are identical by
construction.

State estimate per step: weighted particle mean for x/y; for yaw, the
circular weighted mean re-anchored to the unwrapped branch of the linear
mean, so the track keeps cumulative-yaw continuity (as
poses_from_odometry).

Every cos, sin, exp, atan2 and reduction of a step is rounded once from
float64 (utils/precision.in_float64): the CPU's and CUDA's float32
versions round a last bit apart, a particle a last bit apart scores another
cell now and then, and one such flip reweighs a particle and can move a
resample. So the card's filter follows the CPU's step for step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig
from ..utils import tracing
from ..utils.precision import in_float64
from . import occupancy
from .odometry import _sinc_half, v_from_encoder
from .slam import resolve_device


@dataclass(frozen=True)
class PFConfig:
    """Particle-filter parameters (new surface, no reference analog)."""

    n_particles: int = 256
    sigma_v: float = 0.05       # m/s motion-noise std on linear velocity
    sigma_w: float = 0.05       # rad/s motion-noise std on yaw rate
    # log-weight gain per map-correlation unit; the score is a SUM over
    # rays, so the posterior sharpens with scan size (more evidence)
    temperature: float = 0.1
    resample_frac: float = 0.5  # resample when Neff < frac * n_particles
    dt: float = 1.0 / 40.0      # encoder period (reference FREQ = 40 Hz)


def _cos_sin(theta: torch.Tensor):
    """cos and sin rounded once from float64 (precision.in_float64)."""
    return in_float64(torch.cos, theta), in_float64(torch.sin, theta)


def _score_particles(particles: torch.Tensor, pts: torch.Tensor,
                     mask: torch.Tensor, im: torch.Tensor,
                     map_cfg: MapConfig) -> torch.Tensor:
    """Map-correlation score of one scan under every particle pose.

    particles (P, 3); pts (R, 2) robot-frame points; mask (R,) bool; im
    (W, H) occupancy values (1 at obstacles). Returns (P,) sums of map
    values at each particle's world-frame endpoints (out-of-map and masked
    points add 0), with the map builder's cells (world2grid, ceil - 1), so
    a scan scored at the pose it was painted from hits every endpoint cell.
    """
    c, s = (v[:, None] for v in _cos_sin(particles[:, 2]))
    xw = c * pts[None, :, 0] - s * pts[None, :, 1] + particles[:, 0:1]
    yw = s * pts[None, :, 0] + c * pts[None, :, 1] + particles[:, 1:2]
    gi, gj = occupancy.world2grid(xw, yw, map_cfg)
    ok = (mask[None, :] & (gi >= 0) & (gi < map_cfg.width)
          & (gj >= 0) & (gj < map_cfg.height))
    vals = im[gi.clamp(0, map_cfg.width - 1).long(),
              gj.clamp(0, map_cfg.height - 1).long()]
    return torch.where(ok, vals, torch.zeros_like(vals)).sum(dim=1)


def _systematic_resample(particles: torch.Tensor, w: torch.Tensor,
                         u: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: one uniform draw u in [0, 1) places P evenly
    spaced pointers over the weight CDF (searchsorted, left side, as
    jnp.searchsorted)."""
    P = particles.shape[0]
    cdf = in_float64(torch.cumsum, w, dim=0)
    # divided by a tensor (CUDA multiplies by the reciprocal of a Python
    # scalar), filled on the device (a copy from the host would sync)
    pointers = ((u + torch.arange(P, dtype=w.dtype, device=w.device))
                / torch.full((), P, dtype=w.dtype, device=w.device))
    idx = torch.searchsorted(cdf, pointers)
    return particles[idx.clamp(0, P - 1)]


def _predict_particles(particles: torch.Tensor, v_t, w_t,
                       eps_v: torch.Tensor, eps_w: torch.Tensor,
                       cfg: PFConfig) -> torch.Tensor:
    """Per-particle noisy diff-drive step (sinc-corrected, reference
    modules/localization.py:29-36) from standard-normal draws eps_v, eps_w
    (P,). Shared by pf_step and pf_slam_step."""
    v_p = v_t + cfg.sigma_v * eps_v
    w_p = w_t + cfg.sigma_w * eps_w
    dth = w_p * cfg.dt
    kk = v_p * cfg.dt * in_float64(_sinc_half, dth)
    c, s = _cos_sin(particles[:, 2] + dth / 2.0)
    return torch.stack([
        particles[:, 0] + kk * c,
        particles[:, 1] + kk * s,
        particles[:, 2] + dth,
    ], dim=-1)


def _estimate_pose(particles: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted particle mean; yaw is the circular mean re-anchored to the
    unwrapped branch of the weighted linear mean."""
    def wsum(v):
        return in_float64(torch.sum, w * v)

    c, s = _cos_sin(particles[:, 2])
    lin_yaw = wsum(particles[:, 2])
    circ = in_float64(torch.atan2, wsum(s), wsum(c))
    dc, ds = _cos_sin(circ - lin_yaw)
    return torch.stack([
        wsum(particles[:, 0]),
        wsum(particles[:, 1]),
        lin_yaw + in_float64(torch.atan2, ds, dc),
    ])


def _draw_noise(gen: torch.Generator, P: int, dev: torch.device):
    """One step's (eps_v (P,), eps_w (P,), u ()) from the state's generator."""
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    return (torch.randn(P, **f32), torch.randn(P, **f32),
            torch.rand((), **f32))


def _weigh_and_resample(particles, logw, score, cfg: PFConfig, u):
    """The update half of a step, shared with pf_slam_step: log-weights
    from the scores normalized by logsumexp, the estimate, and the
    branchless resample on Neff collapse. Returns (particles, logw, est,
    neff, do_rs)."""
    P = cfg.n_particles
    logw = logw + cfg.temperature * score
    logw = logw - in_float64(torch.logsumexp, logw, dim=0)
    w = in_float64(torch.exp, logw)
    est = _estimate_pose(particles, w)
    neff = 1.0 / in_float64(torch.sum, w * w)
    do_rs = neff < cfg.resample_frac * P
    res = _systematic_resample(particles, w, u)
    particles = torch.where(do_rs, res, particles)
    logw = torch.where(do_rs, _uniform_logw(P, logw.device), logw)
    return particles, logw, est, neff, do_rs


class PFState(NamedTuple):
    """Streaming filter state: everything pf_step carries between scans."""

    particles: torch.Tensor       # (P, 3)
    logw: torch.Tensor            # (P,) normalized log-weights
    generator: torch.Generator    # random stream, on the state's device


def _uniform_logw(P: int, dev) -> torch.Tensor:
    """(P,) float32 log-weights, all -log(P)."""
    return torch.full((P,), -math.log(P), dtype=torch.float32, device=dev)


def _generator(dev: torch.device, generator, seed: int | None):
    """`generator` (checked to be on dev's type), else a new generator on
    dev seeded with `seed` (default 0)."""
    if generator is not None:
        if generator.device.type != dev.type:
            raise ValueError(f"generator is on {generator.device}, the "
                             f"state on {dev}")
        return generator
    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if seed is None else seed)
    return gen


def init_pf_state(cfg: PFConfig = PFConfig(), x0=None,
                  generator: torch.Generator | None = None,
                  init_particles=None, seed: int | None = None,
                  device="cuda") -> PFState:
    """Initial state on `device`: all particles at x0 (default the origin),
    or `init_particles` (P, 3) for a spread (relocalization) start. The
    random stream is `generator` (on `device`), else a new one seeded with
    `seed` (default 0)."""
    dev = resolve_device(device)
    P = cfg.n_particles
    if init_particles is None:
        x0 = (torch.zeros(3) if x0 is None else torch.as_tensor(x0))
        particles = x0.to(dev, torch.float32).expand(P, 3).clone()
    else:
        particles = torch.as_tensor(init_particles).to(dev, torch.float32)
    return PFState(particles=particles, logw=_uniform_logw(P, dev),
                   generator=_generator(dev, generator, seed))


@tracing.spanned("pf.step")
def pf_step(state: PFState, v_t, w_t, pts, mask, im, map_cfg: MapConfig,
            cfg: PFConfig = PFConfig(), score_fn=None, noise=None):
    """One streaming filter step (the serving analog of online.online_step).

    v_t scalar velocity (v_from_encoder), w_t scalar yaw rate, pts (R, 2)
    robot-frame scan + mask (R,), im (W, H) occupancy on the state's
    device. Returns (new_state, (est_pose (3,), neff, resampled)) as
    tensors; nothing is read back to the host.

    score_fn overrides the scoring: `(particles, pts, mask, im) -> (P,)
    scores`, the hook a particle-sharded scorer plugs into (JAX:
    parallel/sharding.sharded_pf_score). noise, when given, is this step's
    (eps_v (P,), eps_w (P,), u ()) draws, standard normal and uniform in
    [0, 1); the generator is then not touched. It is how a caller replays
    another stream, such as the JAX package's.
    """
    particles, logw, gen = state
    dev = particles.device
    if noise is None:
        noise = _draw_noise(gen, cfg.n_particles, dev)
    eps_v, eps_w, u = noise
    particles = _predict_particles(particles, v_t, w_t, eps_v, eps_w, cfg)
    with tracing.span("pf.score"):
        if score_fn is None:
            score = _score_particles(particles, pts, mask, im, map_cfg)
        else:
            score = score_fn(particles, pts, mask, im)
    with tracing.span("pf.weigh_resample"):
        particles, logw, est, neff, do_rs = _weigh_and_resample(
            particles, logw, score, cfg, u)
    return PFState(particles, logw, gen), (est, neff, do_rs)


def _as_f32(a, dev):
    return torch.as_tensor(a).to(dev, torch.float32)


def localize_particle_filter(
    im,
    counts,
    gyro,
    points,
    masks,
    map_cfg: MapConfig,
    cfg: PFConfig = PFConfig(),
    x0=None,
    generator: torch.Generator | None = None,
    init_particles=None,
    score_fn=None,
    noise=None,
    seed: int | None = None,
    device="cuda",
) -> Tuple[torch.Tensor, dict]:
    """Track the robot pose through a known map, on `device`.

    im (W, H) occupancy (1 at obstacles, e.g. `logodds > 0`); counts (N, 4)
    encoder counts; gyro (N, 3); points (N, R, 2) robot-frame scans with
    masks (N, R); x0 (3,) initial pose. Step i uses encoder/gyro row i and
    is scored against scan i (reference modules/localization.py:60-93).
    init_particles (P, 3) overrides the all-at-x0 start; row 0 of the
    track is still x0. noise, when given, is (eps_v (N-1, P), eps_w
    (N-1, P), u (N-1,)): step i takes row i - 1. score_fn as in pf_step.

    Returns ((N, 3) poses, aux) with aux["neff"] (N,) and
    aux["resampled"] (N,) bool (entries 0 are the initial placeholders).
    """
    dev = resolve_device(device)
    P = cfg.n_particles
    x0 = torch.zeros(3, device=dev) if x0 is None else _as_f32(x0, dev)
    im = _as_f32(im, dev)
    points = _as_f32(points, dev)
    masks = torch.as_tensor(masks).to(dev, torch.bool)
    v_all = v_from_encoder(_as_f32(counts, dev))
    wyaw_all = _as_f32(gyro, dev)[:, -1]
    state = init_pf_state(cfg, x0, generator, init_particles, seed, dev)
    ests, neffs, flags = _placeholders(x0, P)
    for t in range(1, points.shape[0]):
        step_noise = None if noise is None else tuple(
            _as_f32(n[t - 1], dev) for n in noise)
        state, (est, neff, rs) = pf_step(state, v_all[t], wyaw_all[t],
                                         points[t], masks[t], im, map_cfg,
                                         cfg, score_fn, step_noise)
        ests.append(est)
        neffs.append(neff)
        flags.append(rs)
    return torch.stack(ests), {"neff": torch.stack(neffs),
                               "resampled": torch.stack(flags)}


def _placeholders(x0: torch.Tensor, P: int):
    """Row 0 of a track's (poses, neff, resampled) lists: x0, P, False."""
    return ([x0], [torch.full((), float(P), device=x0.device)],
            [torch.zeros((), dtype=torch.bool, device=x0.device)])
