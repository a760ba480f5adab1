"""Particle-filter SLAM: simultaneous localization and occupancy mapping.

Counterpart of lidar_slam_tpu/models/pf_slam.py: no prior map, the filter
scores motion hypotheses against the map built so far and extends that
map with the filtered estimate every step. Per step:
  1. predict  - per-particle noisy sinc diff-drive step
                (particle_filter._predict_particles);
  2. update   - map-correlation scores against the CURRENT causal map's
                obstacle image (logodds > 0), log-weights via logsumexp;
  3. estimate - weighted mean with the cumulative-yaw-continuous yaw;
  4. map      - the reference per-scan log-odds update at the estimate
                (occupancy.update_map, reference modules/ogm.py:149-188):
                the raywalk_scan kernel on CUDA tensors, IN PLACE on the
                carried grid, the port's counterpart of JAX's donated state;
  5. resample - branchless systematic resample on Neff collapse.

Early steps see an all-unknown map (scores 0), so the filter degrades to
dead reckoning until structure appears; scan 0 is painted at x0 by
init_pf_slam. The batch entry is a Python loop over pf_slam_step, and the
random stream and the `noise` argument are as in particle_filter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig
from . import occupancy
from .odometry import v_from_encoder
from .particle_filter import (PFConfig, _as_f32, _draw_noise, _generator,
                              _placeholders, _predict_particles,
                              _score_particles, _uniform_logw,
                              _weigh_and_resample)
from .slam import resolve_device


class PFSlamState(NamedTuple):
    """Streaming SLAM state: everything pf_slam_step carries between scans.
    logodds is updated in place by the next step: clone a state that must
    survive it."""

    particles: torch.Tensor       # (P, 3)
    logw: torch.Tensor            # (P,) normalized log-weights
    generator: torch.Generator    # random stream, on the state's device
    logodds: torch.Tensor         # (W, H) causal log-odds map
    step: torch.Tensor            # () int32, scans consumed


def init_pf_slam(points0, mask0, map_cfg: MapConfig,
                 cfg: PFConfig = PFConfig(), x0=None,
                 generator: torch.Generator | None = None,
                 K: int | None = None, init_particles=None,
                 seed: int | None = None, device="cuda") -> PFSlamState:
    """Initial state on `device`: particles at x0 (or `init_particles`)
    and scan 0 painted at x0 into a zero map by update_map, as
    online.init_state does."""
    dev = resolve_device(device)
    P = cfg.n_particles
    x0 = torch.zeros(3, device=dev) if x0 is None else _as_f32(x0, dev)
    if K is None:
        K = occupancy.max_ray_cells(map_cfg, 30.0)
    if init_particles is None:
        particles = x0.expand(P, 3).clone()
    else:
        particles = _as_f32(init_particles, dev)
    logodds = torch.zeros((map_cfg.width, map_cfg.height),
                          dtype=torch.float32, device=dev)
    occupancy.update_map(logodds, x0, _as_f32(points0, dev)[:, :2],
                         torch.as_tensor(mask0).to(dev, torch.bool),
                         map_cfg, K)
    return PFSlamState(
        particles=particles,
        logw=_uniform_logw(P, dev),
        generator=_generator(dev, generator, seed), logodds=logodds,
        step=torch.ones((), dtype=torch.int32, device=dev))


def pf_slam_step(state: PFSlamState, counts, gyro, pts, mask,
                 map_cfg: MapConfig, cfg: PFConfig = PFConfig(),
                 K: int | None = None, score_fn=None, noise=None):
    """One streaming SLAM step (the PF analog of online.online_step).

    counts (4,) encoder ticks; gyro (3,); pts (R, 2) robot-frame scan +
    mask (R,), on the state's device. Consumes `state`: its logodds is
    updated in place and shared with the returned state. Returns
    (new_state, (est_pose (3,), neff, resampled)); nothing is read back to
    the host. score_fn and noise as in particle_filter.pf_step."""
    if K is None:
        K = occupancy.max_ray_cells(map_cfg, 30.0)
    particles, logw, gen, logodds, step = state
    dev = particles.device
    if noise is None:
        noise = _draw_noise(gen, cfg.n_particles, dev)
    eps_v, eps_w, u = noise

    v_t = v_from_encoder(_as_f32(counts, dev))
    w_t = _as_f32(gyro, dev)[-1]
    particles = _predict_particles(particles, v_t, w_t, eps_v, eps_w, cfg)

    # score against the causal map built so far (1 at obstacles)
    im = (logodds > 0).to(torch.float32)
    if score_fn is None:
        score = _score_particles(particles, pts, mask, im, map_cfg)
    else:
        score = score_fn(particles, pts, mask, im)
    particles, logw, est, neff, do_rs = _weigh_and_resample(
        particles, logw, score, cfg, u)

    # extend the map with this scan at the filtered estimate
    occupancy.update_map(logodds, est, pts[:, :2], mask, map_cfg, K)
    new = PFSlamState(particles, logw, gen, logodds, step + 1)
    return new, (est, neff, do_rs)


def slam_particle_filter(
    counts,
    gyro,
    points,
    masks,
    map_cfg: MapConfig,
    cfg: PFConfig = PFConfig(),
    x0=None,
    generator: torch.Generator | None = None,
    K: int | None = None,
    init_particles=None,
    score_fn=None,
    noise=None,
    seed: int | None = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Run particle-filter SLAM over a whole log on `device`.

    counts (N, 4); gyro (N, 3); points (N, R, 2) robot-frame scans with
    masks (N, R); x0 (3,) initial pose. Step i consumes encoder/gyro row i
    and scores and paints scan i; scan 0 is painted at x0 by init. noise
    as in particle_filter.localize_particle_filter.

    Returns ((N, 3) poses, (W, H) final log-odds map, aux) with aux =
    {"neff": (N,), "resampled": (N,)} (entries 0 are placeholders). The
    map is CAUSAL, built from the estimate available at each step.
    """
    dev = resolve_device(device)
    x0 = torch.zeros(3, device=dev) if x0 is None else _as_f32(x0, dev)
    if K is None:
        K = occupancy.max_ray_cells(map_cfg, 30.0)
    counts, gyro = _as_f32(counts, dev), _as_f32(gyro, dev)
    points = _as_f32(points, dev)[..., :2]
    masks = torch.as_tensor(masks).to(dev, torch.bool)
    state = init_pf_slam(points[0], masks[0], map_cfg, cfg, x0, generator,
                         K, init_particles, seed, dev)
    ests, neffs, flags = _placeholders(x0, cfg.n_particles)
    for t in range(1, points.shape[0]):
        step_noise = None if noise is None else tuple(
            _as_f32(n[t - 1], dev) for n in noise)
        state, (est, neff, rs) = pf_slam_step(
            state, counts[t], gyro[t], points[t], masks[t], map_cfg, cfg, K,
            score_fn, step_noise)
        ests.append(est)
        neffs.append(neff)
        flags.append(rs)
    return (torch.stack(ests), state.logodds,
            {"neff": torch.stack(neffs), "resampled": torch.stack(flags)})
