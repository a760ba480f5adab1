"""The port's scan filters (ops/filters.py, models/slam.filter_scans) held to
the benchmark's plain float64 filter (slambench/reference/filters.py), the
benchmark's corridor log generator (slambench/synth_corridor.py) at full
width, and the filter's spans and counters (utils/tracing), on the CPU."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "slambench"
if str(BENCH) not in sys.path:
    # appended, so that the benchmark's trace.py does not shadow the
    # standard library's
    sys.path.append(str(BENCH))

import synth  # noqa: E402
import synth_corridor  # noqa: E402
from reference import filters as rfilt  # noqa: E402

import lidar_slam_tpu_torch.config as tc  # noqa: E402
from lidar_slam_tpu_torch.models import slam  # noqa: E402
from lidar_slam_tpu_torch.ops import filters as pf  # noqa: E402
from lidar_slam_tpu_torch.ops import scan as scan_ops  # noqa: E402
from lidar_slam_tpu_torch.utils import tracing  # noqa: E402

EPS, MIN_SAMPLES, K_STD = 0.1, 10, 2.0
# The statistical threshold: the port pools float32 ranges in another
# order than the reference's float64 sums (as tests/test_torch_filters.py).
THRESH_RTOL = 1e-6


def dbscan_margin(pts: torch.Tensor) -> float:
    """Relative margin of eps^2 within which a pair may fall either side.
    The port forms d^2 = |a|^2 - 2 a.b + |b|^2 in float32, each of its
    eight products and sums rounded once (ops/filters._pair_d2): for
    coordinates up to R the cancellation leaves at most 16 * 2^-24 * R^2,
    against the reference's squared float64 differences; and its eps^2 is
    float32(0.1)^2 rounded to float32 (2^-22 relative)."""
    r2 = float((pts.double() ** 2).sum(-1).max())
    return 16 * 2.0 ** -24 * r2 / EPS ** 2 + 2.0 ** -22


def _pad(scans, P, rng):
    """(N, P, 2) float32 points and (N, P) masks of ragged scans, padded
    with invalid points at random places."""
    pts = rng.uniform(-4, 4, (len(scans), P, 2)).astype(np.float32)
    mask = np.zeros((len(scans), P), bool)
    for i, s in enumerate(scans):
        pts[i, :len(s)] = s
        mask[i, :len(s)] = True
    return torch.from_numpy(pts), torch.from_numpy(mask)


def clustered(rng):
    """Dense blobs, a borderline chain and far outliers."""
    scans = [np.vstack([rng.normal(0, 0.02, (80, 2)) + [1.0, 0.5],
                        rng.normal(0, 0.03, (40, 2)) - 2.0,
                        np.linspace([0, 0], [0.5, 0], 12)
                        + rng.normal(0, 0.005, (12, 2)),
                        rng.uniform(3, 4, (8, 2)) * rng.choice([-1, 1],
                                                               (8, 2))])
             for _ in range(3)]
    return _pad(scans, 160, rng)


def sparse(rng):
    """Points strewn over 6 m x 6 m: next to none has ten within eps."""
    return _pad([rng.uniform(-3, 3, (n, 2)) for n in (200, 150, 90)], 200,
                rng)


def all_invalid(rng):
    pts, _ = _pad([rng.normal(0, 0.02, (60, 2))] * 2, 60, rng)
    return pts, torch.zeros(pts.shape[:2], dtype=torch.bool)


def lone_core(rng):
    """One core point: a centre with nine points 0.09 m around it (each of
    those with four valid points within eps, itself included: the centre
    and its two neighbours on the ring), and far noise."""
    a = np.linspace(0, 2 * np.pi, 9, endpoint=False)
    ring = 0.09 * np.stack([np.cos(a), np.sin(a)], -1) + [1.5, -0.5]
    far = rng.uniform(-3, -2, (20, 2))
    return _pad([np.vstack([[[1.5, -0.5]], ring, far])], 40, rng)


def corridor(rng):
    """Four full-width scans of the corridor log: the deployment's density."""
    d = synth_corridor.corridor_dataset(n_steps=1200, seed=5)
    r = torch.as_tensor(d["lidar"]["ranges"][::300], dtype=torch.float32)
    return scan_ops.scans_to_points(r, 0.1, 30.0, tc.LidarConfig())


SCENES = [clustered, sparse, all_invalid, lone_core, corridor]


@pytest.mark.parametrize("scene", SCENES, ids=lambda f: f.__name__)
def test_port_filters_equal_the_reference(scene):
    pts, mask = scene(np.random.default_rng(21))
    p64 = pts.double()
    m = dbscan_margin(pts[mask]) if mask.any() else 0.0
    # DBSCAN's kept set grows with eps, so the port's lies between the
    # reference's at eps^2 (1 -/+ m), and equals it where those agree
    lo = rfilt.dbscan_keep(p64, mask, EPS * (1 - m) ** 0.5, MIN_SAMPLES)
    hi = rfilt.dbscan_keep(p64, mask, EPS * (1 + m) ** 0.5, MIN_SAMPLES)
    ref = rfilt.dbscan_keep(p64, mask, EPS, MIN_SAMPLES)
    db = pf.dbscan_filter_scans(pts, mask, EPS, MIN_SAMPLES)
    assert not (lo & ~db).any() and not (db & ~hi).any()
    assert torch.equal(db[lo == hi], ref[lo == hi])
    if scene is lone_core:
        assert torch.equal(db[0, :10], torch.ones(10, dtype=torch.bool))
        assert not db[0, 10:].any()
    if scene in (sparse, all_invalid):
        assert not db.any()
    # the statistical filter on the same masks: equal outside a band
    # about the reference's threshold
    r = p64.norm(dim=-1)
    pooled = r[db]
    thr = (pooled.mean() + K_STD * pooled.std(unbiased=False)
           if pooled.numel() else torch.tensor(0.0, dtype=torch.float64))
    band = (r - thr).abs() <= THRESH_RTOL * thr
    want = rfilt.statistical_keep(p64, db, K_STD)
    got = pf.statistical_filter_scans(pts, db, K_STD)
    assert torch.equal(got[~band], want[~band])
    # filter_scans: both, in that order
    both = slam.filter_scans(pts, mask, tc.SlamConfig())
    assert torch.equal(both[~band], want[~band])
    assert not (both & ~mask).any()


def test_corridor_log_shapes_and_kept_share():
    n = 1600
    got = synth_corridor.corridor_dataset(n_steps=n, seed=3)
    want = synth.synthetic_dataset(n_steps=n, seed=3)
    assert set(got) == set(want)
    for group, items in want.items():
        pairs = (items.items() if isinstance(items, dict)
                 else [(None, items)])
        if isinstance(items, dict):
            assert set(got[group]) == set(items), group
        for k, v in pairs:
            g = got[group] if k is None else got[group][k]
            assert np.shape(g) == np.shape(v), (group, k)
            assert np.asarray(g).dtype == np.asarray(v).dtype, (group, k)
    # after both filters (every 40th scan: the first leg, a corner and a
    # side), most of every scan stays
    r = torch.as_tensor(got["lidar"]["ranges"][::40], dtype=torch.float32)
    pts, mask = scan_ops.scans_to_points(r, 0.1, 30.0, tc.LidarConfig())
    kept = slam.filter_scans(pts, mask, tc.SlamConfig()).sum(-1)
    share = kept.double() / mask.sum(-1).double()
    assert float(share.median()) >= 0.6
    assert int(kept.min()) >= 300


@pytest.fixture
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def test_filter_spans_and_counters(_tracing_off):
    n_steps, n_rays = 37, 181
    d = synth_corridor.corridor_dataset(n_steps=n_steps, n_rays=n_rays,
                                        seed=2)
    cfg = tc.SlamConfig(lidar=tc.LidarConfig(n_rays=n_rays))
    args = (d["encoder"]["counts"].astype(np.float32),
            d["imu"]["angular_velocity"].astype(np.float32),
            d["lidar"]["ranges"].astype(np.float32), 0.1, 30.0)

    def run():
        return slam.run_slam(*args, mode="odom", filter_lidar=True, cfg=cfg,
                             build_map=False, device="cpu")

    run()
    snap = tracing.snapshot()
    assert snap["spans"] == [] and not any(
        k.startswith("filter.") for k in snap["counts"])
    assert not tracing.enabled()
    tracing.enable()
    assert tracing.enabled()
    run()
    snap = tracing.snapshot()
    tracing.disable()
    by_id = {s.id: s for s in snap["spans"]}
    outer = [s for s in snap["spans"] if s.name == "slam.filter"]
    assert len(outer) == 1
    inner = [s.name for s in snap["spans"] if s.parent == outer[0].id]
    assert inner == ["filter.dbscan", "filter.statistical"]
    for s in snap["spans"]:
        if s.name.startswith("filter."):
            assert by_id[s.parent].name == "slam.filter"
            assert outer[0].start_ns <= s.start_ns <= s.end_ns \
                <= outer[0].end_ns
    chunks = -(-n_steps // 16)  # dbscan_filter_scans' default chunk
    assert snap["counts"]["filter.chunks"] == chunks == 3
    assert snap["counts"]["filter.pairs"] == n_steps * n_rays * n_rays
