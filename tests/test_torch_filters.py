"""The port's scan filters (ops/filters.py) against the JAX package's
(lidar_slam_tpu/ops/filters.py) and sklearn's DBSCAN, on the same seeded
numpy inputs, on the CPU.

Contract: DBSCAN masks equal to JAX's and to sklearn's noise set, labels
partition-equal to sklearn's; the statistical threshold within 1e-6
relative of JAX's (the pooled sums are taken in another order), and the
masks equal for every point whose range lies outside that band of it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_slam_tpu.ops import filters as jf
from lidar_slam_tpu.utils import io as jio

from lidar_slam_tpu_torch.config import LidarConfig
from lidar_slam_tpu_torch.ops import filters as tf
from lidar_slam_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)

THRESH_RTOL = 1e-6  # pooled float32 sums in another order


def _scan_with_outliers(rng, n_core=80, n_out=8):
    """A dense blob (core cluster) plus isolated far points (outliers)."""
    blob = rng.normal(0, 0.02, (n_core, 2)) + np.array([1.0, 0.5])
    outs = rng.uniform(5, 8, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return np.vstack([blob, outs])


def _mixed_scan(rng):
    """_scan_with_outliers plus a second cluster and a borderline chain
    (tests/test_filters.py's scene), float32."""
    pts = _scan_with_outliers(rng)
    return np.vstack([pts, rng.normal(0, 0.03, (40, 2)) - 2.0,
                      np.linspace([0, 0], [0.5, 0], 12)
                      + rng.normal(0, 0.005, (12, 2))]).astype(np.float32)


@pytest.fixture(scope="module")
def lidar_scans():
    """(points (N, 1081, 2), masks) float32 of 24 synthetic full scans
    (the density the pipeline's eps = 0.1 m assumes)."""
    d = jio.synthetic_dataset(n_steps=24, seed=9)
    ranges = torch.as_tensor(d["lidar"]["ranges"], dtype=torch.float32)
    pts, masks = tscan.scans_to_points(ranges, 0.1, 30.0, LidarConfig())
    return pts.numpy(), masks.numpy()


def test_dbscan_mask_matches_sklearn():
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(0)
    for trial in range(5):
        pts = _mixed_scan(rng)
        want = DBSCAN(eps=0.1, min_samples=10).fit_predict(pts) != -1
        got = tf.dbscan_outlier_mask(torch.from_numpy(pts),
                                     torch.ones(len(pts), dtype=torch.bool),
                                     0.1, 10)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"trial {trial}")
        assert want.any() and not want.all()


def test_dbscan_masked_equals_subset():
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(1)
    pts = _scan_with_outliers(rng, 60, 6).astype(np.float32)
    mask = rng.random(len(pts)) > 0.25
    got = tf.dbscan_outlier_mask(torch.from_numpy(pts),
                                 torch.from_numpy(mask), 0.1, 10).numpy()
    want_sub = DBSCAN(eps=0.1, min_samples=10).fit_predict(pts[mask]) != -1
    np.testing.assert_array_equal(got[mask], want_sub)
    assert not got[~mask].any()


@pytest.mark.parametrize("source", ["scenes", "lidar"])
def test_dbscan_filter_scans_equal_jax(lidar_scans, source):
    """Masks equal to JAX's, bit for bit, on the outlier scenes and on
    full 1,081-ray synthetic scans with a quarter of their points masked
    out."""
    rng = np.random.default_rng(2)
    if source == "scenes":
        pts = np.stack([_mixed_scan(rng) for _ in range(6)])
        masks = rng.random(pts.shape[:2]) > 0.1
    else:
        pts, masks = lidar_scans
        masks = masks & (rng.random(masks.shape) > 0.25)
    want = np.asarray(jf.dbscan_filter_scans(jnp.asarray(pts),
                                             jnp.asarray(masks),
                                             chunk_size=4))
    got = tf.dbscan_filter_scans(torch.from_numpy(pts),
                                 torch.from_numpy(masks), chunk_size=4)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < masks.sum()


def test_dbscan_labels_partition_matches_sklearn():
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(2)
    pts = np.vstack([rng.normal(0, 0.02, (30, 2)),
                     rng.normal(0, 0.02, (30, 2)) + 3.0,
                     np.array([[10.0, 10.0]])]).astype(np.float32)
    want = DBSCAN(eps=0.1, min_samples=5).fit_predict(pts)
    got = tf.dbscan_labels(torch.from_numpy(pts),
                           torch.ones(len(pts), dtype=torch.bool), 0.1,
                           5).numpy()
    # same noise set and same partition (label ids may differ)
    np.testing.assert_array_equal(got == -1, want == -1)
    for lab in set(want[want >= 0]):
        assert len(set(got[want == lab])) == 1
    assert len(set(got[got >= 0])) == len(set(want[want >= 0])) == 2
    jax_labels = np.asarray(jf.dbscan_labels(
        jnp.asarray(pts), jnp.ones(len(pts), bool), 0.1, 5))
    np.testing.assert_array_equal(got, jax_labels)


def test_dbscan_labels_long_chain_fixpoint():
    """A core chain of 300 points 5 cm apart (299 hops) collapses to one
    label: the propagation runs to its fixpoint, not a fixed sweep count."""
    P = 300
    pts = torch.stack([torch.arange(P, dtype=torch.float32) * 0.05,
                       torch.zeros(P)], dim=-1)
    labels = tf.dbscan_labels(pts, torch.ones(P, dtype=torch.bool), eps=0.06,
                              min_samples=2)
    assert (labels == 0).all(), torch.unique(labels)


def test_chunked_equals_unchunked(lidar_scans):
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(np.stack([_scan_with_outliers(rng, 40, 4)
                                     for _ in range(7)]).astype(np.float32))
    masks = torch.ones(pts.shape[:2], dtype=torch.bool)
    a = tf.dbscan_filter_scans(pts, masks, chunk_size=2)
    b = tf.dbscan_filter_scans(pts, masks, chunk_size=7)
    c = tf.dbscan_filter_scans(pts, masks)  # the default, 16
    assert torch.equal(a, b) and torch.equal(a, c)
    lp, lm = map(torch.from_numpy, lidar_scans)
    assert torch.equal(tf.dbscan_filter_scans(lp, lm, chunk_size=5),
                       tf.dbscan_filter_scans(lp, lm, chunk_size=24))


def _jax_threshold(pts, masks, k_std):
    """JAX's threshold, by its own formula on the same float32 arrays."""
    d = jnp.linalg.norm(jnp.asarray(pts), axis=-1)
    w = jnp.asarray(masks).astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(d * w) / n
    var = jnp.sum((d - mean) ** 2 * w) / n
    return float(mean + k_std * jnp.sqrt(var))


@pytest.mark.parametrize("source", ["uniform", "lidar"])
def test_statistical_filter_equals_jax_outside_the_band(lidar_scans, source):
    """The threshold within THRESH_RTOL of JAX's; masks equal to JAX's for
    every point whose range lies outside that band of the threshold (the
    points inside it are counted: none on these inputs)."""
    rng = np.random.default_rng(3)
    if source == "uniform":
        pts = np.stack([rng.uniform(0.5, 5.0, (50, 2)),
                        rng.uniform(0.5, 25.0, (50, 2))]).astype(np.float32)
        masks = np.ones((2, 50), bool)
    else:  # one point in 50 pushed three times as far out
        pts, masks = lidar_scans
        far = rng.random(masks.shape) < 0.02
        pts = np.where(far[..., None], 3 * pts, pts).astype(np.float32)
        masks = masks & (rng.random(masks.shape) > 0.1)
    d, thresh = tf.statistical_threshold(torch.from_numpy(pts),
                                         torch.from_numpy(masks), 2.0)
    want_t = _jax_threshold(pts, masks, 2.0)
    assert abs(float(thresh) - want_t) <= THRESH_RTOL * abs(want_t)
    want = np.asarray(jf.statistical_filter_scans(
        jnp.asarray(pts), jnp.asarray(masks), k_std=2.0))
    got = tf.statistical_filter_scans(torch.from_numpy(pts),
                                      torch.from_numpy(masks), 2.0).numpy()
    band = np.abs(d.numpy() - want_t) <= THRESH_RTOL * abs(want_t)
    assert band.sum() == 0
    np.testing.assert_array_equal(got[~band], want[~band])
    assert 0 < (masks & ~want).sum() < masks.sum() // 4


def test_statistical_filter_matches_reference_spec():
    """numpy's float64 spec (modules/localization.py:223-250: pooled mean +
    2 sigma, keep <) on the same points."""
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(0.5, 5.0, (50, 2)),
                    rng.uniform(0.5, 25.0, (50, 2))])
    got = tf.statistical_filter_scans(torch.from_numpy(pts),
                                      torch.ones((2, 50), dtype=torch.bool))
    d = np.linalg.norm(pts.reshape(-1, 2), axis=1)
    want = (d < d.mean() + 2.0 * d.std()).reshape(2, 50)
    np.testing.assert_array_equal(got.numpy(), want)


def test_statistical_filter_ignores_masked_points():
    rng = np.random.default_rng(4)
    pts = np.vstack([rng.uniform(0.5, 2.0, (40, 2)),
                     np.full((10, 2), 500.0)]).astype(np.float32)
    masks = np.concatenate([np.ones(40, bool), np.zeros(10, bool)])
    got = tf.statistical_filter_scans(torch.from_numpy(pts[None]),
                                      torch.from_numpy(masks[None]))[0]
    d = np.linalg.norm(pts[:40], axis=1)
    np.testing.assert_array_equal(got[:40].numpy(),
                                  d < d.mean() + 2 * d.std())
    assert not got[40:].any()
