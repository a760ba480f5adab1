"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have is planted in the program, the rest of the run is
driven as on the card (the look for a card skipped, small logs on the
CPU), and `correct` must read false. One chip has no exchange between
chips to leave out."""

import pytest
import torch

from bench_paths import tiny_cell, cpu_run


def _offline_state_unchanged(mp):
    import lidar_slam_tpu_torch.ops.icp as icp

    def body(src, tgt, sm, tm, c, *a, **k):
        return c._replace(done=torch.ones_like(c.done))
    mp.setattr(icp, "_icp_body", body)


def _offline_half_batch(mp):
    import lidar_slam_tpu_torch.models.scan_matching as sm

    orig = sm.icp_all_pairs

    def half(src, tgt, src_mask, tgt_mask, init_T, **k):
        h = src.shape[0] // 2
        T, e, it = orig(src[:h], tgt[:h], src_mask[:h], tgt_mask[:h],
                        init_T[:h], **k)
        return (torch.cat([T, init_T[h:]]), torch.cat([e, e.new_zeros(
            src.shape[0] - h)]), torch.cat([it, it.new_zeros(
                src.shape[0] - h)]))
    mp.setattr(sm, "icp_all_pairs", half)


def _offline_answer_altered(mp):
    import lidar_slam_tpu_torch.models.scan_matching as sm

    orig = sm.poses_from_scan_matching

    def altered(*a, **k):
        r = orig(*a, **k)
        rel = r.relative_poses.clone()
        rel[:, 0, 2] += 1e-3
        return r._replace(relative_poses=rel)
    mp.setattr(sm, "poses_from_scan_matching", altered)


def _offline_map_altered(mp):
    import lidar_slam_tpu_torch.models.occupancy as occ

    orig = occ.build_logodds

    def altered(*a, **k):
        g = orig(*a, **k)
        g[g.shape[0] // 2:] += 1.0
        return g
    mp.setattr(occ, "build_logodds", altered)


def _online_state_unchanged(mp):
    import lidar_slam_tpu_torch.models.online as online

    mp.setattr(online, "online_step",
               lambda state, *a, **k: state._replace(step=state.step + 1))


def _online_answer_altered(mp):
    import lidar_slam_tpu_torch.models.online as online

    orig = online.online_step

    def altered(*a, **k):
        s = orig(*a, **k)
        slot = int(s.step) % s.poses_hist.shape[0]
        s.poses_hist[slot] += 0.01
        return s._replace(pose=s.poses_hist[slot])
    mp.setattr(online, "online_step", altered)


def _online_map_unpainted(mp):
    import lidar_slam_tpu_torch.models.online as online
    import lidar_slam_tpu_torch.models.occupancy as occ

    orig = online.online_step

    def unpainted(*a, **k):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(occ, "update_map", lambda grid, *a, **k: grid)
            return orig(*a, **k)
    mp.setattr(online, "online_step", unpainted)


def _pf_state_unchanged(mp):
    import lidar_slam_tpu_torch.models.particle_filter as pfm

    orig = pfm.pf_step

    def unchanged(state, *a, **k):  # the estimate is still right
        return state, orig(state, *a, **k)[1]
    mp.setattr(pfm, "pf_step", unchanged)


def _pf_wrong_resample(mp):
    import lidar_slam_tpu_torch.models.particle_filter as pfm

    def multinomial(particles, w, u):
        g = torch.Generator(device=w.device).manual_seed(0)
        return particles[torch.multinomial(w, particles.shape[0], True,
                                           generator=g)]
    mp.setattr(pfm, "_systematic_resample", multinomial)


def _pf_half_batch(mp):
    import lidar_slam_tpu_torch.models.particle_filter as pfm

    orig = pfm._estimate_pose

    def half(particles, w):
        h = particles.shape[0] // 2
        return orig(particles[:h], w[:h] / w[:h].sum())
    mp.setattr(pfm, "_estimate_pose", half)


def _pf_answer_altered(mp):
    import lidar_slam_tpu_torch.models.particle_filter as pfm

    orig = pfm.pf_step

    def altered(*a, **k):
        s, (est, neff, rs) = orig(*a, **k)
        return s, (est + 0.01, neff, rs)
    mp.setattr(pfm, "pf_step", altered)


def _small(cell):
    """The deployment's 0.05 m cells, so a map fault touches as many cells
    a scan as on the card; stream logs longer than the window covers, so
    the session judged is the whole window's; the filter's scans at the
    deployment's 1,081 rays, so its weights collapse and it resamples on
    about as many steps as on the card."""
    return tiny_cell(cell, steps=120 if "offline" in cell else 600,
                     rays=1081 if "localize" in cell else 181, res=0.05)


FAULTS = [
    ("ds20.offline_gtsam", _offline_state_unchanged),
    ("ds20.offline_gtsam", _offline_half_batch),
    ("ds20.offline_gtsam", _offline_answer_altered),
    ("ds20.offline_gtsam", _offline_map_altered),
    ("ds20.online_slam", _online_state_unchanged),
    ("ds20.online_slam", _online_answer_altered),
    ("ds20.online_slam", _online_map_unpainted),
    ("ds21.online_localize", _pf_state_unchanged),
    ("ds21.online_localize", _pf_wrong_resample),
    ("ds21.online_localize", _pf_half_batch),
    ("ds21.online_localize", _pf_answer_altered),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_fault_makes_the_run_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = cpu_run(_small(cell))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", sorted({c for c, _ in FAULTS}))
def test_unbroken_run_at_that_size_is_correct(cell):
    res = cpu_run(_small(cell))
    assert res["correct"], res["compared"]
