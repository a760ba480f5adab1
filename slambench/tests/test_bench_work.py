"""The yardstick's operations and bytes, on shapes worked by hand."""

import pytest

from bench_paths import BENCH  # noqa: F401  (sys.path)
import work  # noqa: E402


def test_nn_work_counts_valid_pairs_and_each_byte_once():
    # 2 pairs of 3-D clouds, 100 sources and 80 targets each; 90 x 70 and
    # 50 x 80 valid pairs
    sweeps = [{"B": 2, "N": 100, "M": 80, "D": 3,
               "valid_pairs": 90 * 70 + 50 * 80}]
    ops, nbytes = work.nn_work(sweeps)
    assert ops == 6 * (6300 + 4000)
    # sources 2*100*12, targets 2*80*12, masks 2*80, indices 2*100*4,
    # matches 2*100*12
    assert nbytes == 2400 + 1920 + 160 + 800 + 2400


def test_nn_work_sums_sweeps():
    s = {"B": 1, "N": 10, "M": 10, "D": 2, "valid_pairs": 100}
    one = work.nn_work([s])
    two = work.nn_work([s, s])
    assert two == (2 * one[0], 2 * one[1])


def test_raywalk_work():
    # 3 scans of 4 rays on a 10 x 20 grid, 50 visits: rays 3*4*17 bytes,
    # grid 800 bytes out (and 800 in when updated in place)
    assert work.raywalk_work(3, 4, 10, 20, 50, False) == (50.0, 204 + 800)
    assert work.raywalk_work(3, 4, 10, 20, 50, True) == (50.0, 204 + 1600)


def test_roofline_share_takes_the_larger_bound():
    flops, bw = work.PEAKS["fp32_flops"], work.PEAKS["hbm_bytes_per_s"]
    # compute-bound: 67e9 ops need 1 ms; measured 4 ms -> 25%
    assert work.roofline_share(flops * 1e-3, 0.0, 4e-3) == pytest.approx(25)
    # bytes-bound: 3.35e9 bytes need 1 ms; measured 2 ms -> 50%
    assert work.roofline_share(1.0, bw * 1e-3, 2e-3) == pytest.approx(50)
    assert work.roofline_share(1.0, 1.0, 0.0) is None
