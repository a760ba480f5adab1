"""One step of particle-filter localization against an occupancy map,
written plainly: the noisy sinc differential-drive motion of every
particle, the map-correlation score of the scan at each particle (the sum
over valid rays of the occupancy of the cell the rotated and moved point
falls in; off-map points score 0), weights w ~ exp(log w + temperature x
score) normalized to sum 1, and the estimate: the weighted mean position,
and a yaw that is the weighted mean yaw moved onto the weighted circular
mean, wrapped into its half-turn.
"""

from __future__ import annotations

import math

import torch

from . import geometry as geo
from .mapping import cells


def _moved_and_logw(particles, logw, v, w, eps_v, eps_w, pts, mask, occ,
                    m: dict, pf: dict):
    """The particles after the noisy motion and their unnormalized
    log-weights after the scan's score."""
    dt = pf["dt"]
    vp = v + pf["sigma_v"] * eps_v
    wp = w + pf["sigma_w"] * eps_w
    dth = wp * dt
    h = dth / 2.0
    small = torch.abs(h) < 1e-8
    hs = torch.where(small, torch.ones_like(h), h)
    sinc = torch.where(small, 1.0 - h * h / 6.0, torch.sin(hs) / hs)
    k = vp * dt * sinc
    heading = particles[:, 2] + h
    moved = torch.stack([particles[:, 0] + k * torch.cos(heading),
                         particles[:, 1] + k * torch.sin(heading),
                         particles[:, 2] + dth], dim=-1)
    T = geo.T_of(moved)
    world = geo.mm(pts[None], T[:, :2, :2].transpose(-1, -2)) + T[:, None,
                                                                 :2, 2]
    gi = cells(world[..., 0], m["world_min_x"], m["resolution"])
    gj = cells(world[..., 1], m["world_min_y"], m["resolution"])
    on = (mask[None] & (gi >= 0) & (gi < m["width"]) & (gj >= 0)
          & (gj < m["height"]))
    vals = occ[gi.clamp(0, m["width"] - 1), gj.clamp(0, m["height"] - 1)]
    score = torch.where(on, vals, torch.zeros_like(vals)).sum(-1)
    return moved, logw + pf["temperature"] * score


def _estimate(moved, lw):
    wts = torch.softmax(lw, dim=0)
    lin = (wts * moved[:, 2]).sum()
    circ = torch.atan2((wts * torch.sin(moved[:, 2])).sum(),
                       (wts * torch.cos(moved[:, 2])).sum())
    return torch.stack([(wts * moved[:, 0]).sum(), (wts * moved[:, 1]).sum(),
                        lin + geo.wrap(circ - lin)])


def step(particles, logw, v, w, eps_v, eps_w, u, pts, mask, occ, m: dict,
         pf: dict):
    """A whole step: (particles, log-weights, estimate) after it. After the
    estimate, when the effective sample size 1 / sum w^2 falls below
    resample_frac x P, the particles are resampled systematically (P
    pointers (u + k) / P into the weights' running sum, the first entry not
    below each) and the weights reset to equal."""
    moved, lw = _moved_and_logw(particles, logw, v, w, eps_v, eps_w, pts,
                                mask, occ, m, pf)
    est = _estimate(moved, lw)
    wts = torch.softmax(lw, dim=0)
    P = particles.shape[0]
    if float(1.0 / (wts * wts).sum()) < pf["resample_frac"] * P:
        ptr = (u + torch.arange(P, dtype=wts.dtype, device=wts.device)) / P
        idx = torch.searchsorted(torch.cumsum(wts, 0), ptr).clamp(0, P - 1)
        moved = moved[idx]
        lw = torch.full_like(lw, -math.log(P))
    else:
        lw = lw - torch.logsumexp(lw, 0)
    return moved, lw, est
