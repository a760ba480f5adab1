"""The NN kernel's exactness oracle, kernels/nn.nn_argmin_rounded, on the
CPU against the JAX package's nearest_neighbors (lidar_slam_tpu/ops/nn.py)
and the port's plain version.

The oracle repeats the Hopper kernel's arithmetic op by op; on the card
the kernel's indices must equal it exactly (tests/test_torch_kernels.py).
Here it is held to the JAX function: the same chosen distances up to the
float32 rounding of the cross term (the JAX einsum rounds it in another
order), exactly the same indices where nothing rounds, and the JAX
function's tie and mask rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.ops import nn as jnn
from lidar_slam_tpu_torch.kernels.nn import nn_argmin_rounded
from lidar_slam_tpu_torch.ops.nn import nearest_neighbors

torch.set_num_threads(1)

REL = 1e-5  # chosen squared distances, relative (float32 cross terms)
MAX_FLIPS = 0.01  # share of indices that may flip between near-ties


def _jax_nn(src, tgt, mask):
    with jax.enable_x64(False):
        return np.asarray(jnn.nearest_neighbors(
            jnp.asarray(src), jnp.asarray(tgt),
            None if mask is None else jnp.asarray(mask)))


def _oracle(src, tgt, mask):
    idx, matched = nn_argmin_rounded(
        torch.from_numpy(src), torch.from_numpy(tgt),
        None if mask is None else torch.from_numpy(mask))
    assert idx.dtype == torch.int32 and matched.shape == src.shape
    np.testing.assert_array_equal(
        matched.numpy(), np.take_along_axis(tgt, idx.numpy()[..., None], -2))
    return idx.numpy()


@pytest.mark.parametrize("B,N,M,D,masked", [
    (3, 200, 150, 3, False), (2, 130, 257, 3, True), (1, 64, 90, 2, False),
    (1, 1081, 1081, 3, True),
])
def test_rounded_matches_jax(B, N, M, D, masked):
    rng = np.random.default_rng(B * N + M)
    src = rng.normal(size=(B, N, D)).astype(np.float32)
    tgt = rng.normal(size=(B, M, D)).astype(np.float32)
    mask = rng.random((B, M)) > 0.4 if masked else None
    got, want = _oracle(src, tgt, mask), _jax_nn(src, tgt, mask)
    assert float((got != want).mean()) <= MAX_FLIPS

    def d(i):
        t = np.take_along_axis(tgt, i[..., None].astype(np.int64), -2)
        return ((src.astype(np.float64) - t) ** 2).sum(-1)

    rel = np.abs(d(got) - d(want)) / np.maximum(d(want), 1e-12)
    assert rel.max() <= REL, rel.max()
    if mask is not None:
        assert np.take_along_axis(mask, got, -1).all()


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_rounded_equals_plain_on_integers(D, masked):
    """Integer coordinates: nothing rounds, so every exact tie is a tie in
    all three, and the lowest index wins in all three."""
    rng = np.random.default_rng(10 * D + masked)
    src = rng.integers(-6, 7, (2, 300, D)).astype(np.float32)
    tgt = rng.integers(-6, 7, (2, 400, D)).astype(np.float32)
    mask = rng.random((2, 400)) > 0.3 if masked else None
    got = _oracle(src, tgt, mask)
    plain = nearest_neighbors(torch.from_numpy(src), torch.from_numpy(tgt),
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, _jax_nn(src, tgt, mask))


@pytest.mark.parametrize("n_masked", range(4))
def test_rounded_planted_duplicates(n_masked):
    """Copies of one target at indices 3, 40, 700 and 1,050 (other lanes of
    a warp, other shared-memory positions) and sources exactly on it: the
    lowest unmasked copy wins."""
    planted = [3, 40, 700, 1050]
    rng = np.random.default_rng(7)
    src = rng.normal(0, 3, (1, 1081, 3)).astype(np.float32)
    tgt = rng.normal(0, 3, (1, 1081, 3)).astype(np.float32)
    point = np.array([2.0, -1.0, 0.5], np.float32)
    tgt[0, planted] = point
    src[0, ::5] = point
    mask = np.ones((1, 1081), bool)
    mask[0, planted[:n_masked]] = False
    got = _oracle(src, tgt, mask)
    assert (got[0, ::5] == planted[n_masked]).all()
    np.testing.assert_array_equal(_jax_nn(src, tgt, mask)[0, ::5],
                                  got[0, ::5])


def test_rounded_all_masked_row():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(2, 50, 3)).astype(np.float32)
    tgt = rng.normal(size=(2, 70, 3)).astype(np.float32)
    mask = rng.random((2, 70)) > 0.5
    mask[1] = False
    got = _oracle(src, tgt, mask)
    assert (got[1] == 0).all()
    np.testing.assert_array_equal(_jax_nn(src, tgt, mask)[1], got[1])
    assert np.take_along_axis(mask[:1], got[:1], -1).all()
