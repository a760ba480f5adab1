"""Operations and bytes of one K6 solve (the program's block-tridiagonal
SPIKE solve, csrc/tridiag.cu; models/pose_graph.block_tridiag_solve),
counted from its shape whatever implements it, and its share of the
roofline.

T X = R with A (n, b, b) diagonal blocks, O (n - 1, b, b) sub-diagonal
blocks and R (n, b, m): a chain of more than 2q blocks splits into B =
ceil(n / q) segments of q blocks (one segment of n blocks otherwise).
Each segment eliminates its q - 1 interior blocks by block Thomas against
the panel [R | E_f | E_l] of m + 2b columns, the segments' last blocks
form a block-tridiagonal interface system of B blocks, and the interior
solutions follow from the interface's. Counted in float64 operations (K6
computes in float64 whatever its inputs' dtype), a multiply-add as two, a
b x b product or Gauss-Jordan inversion as 2 b^3; in bytes, A, O and R
read once and X written once at the element size of the panels K6
receives (float64 from the direct solve on the card, float32 from the
banded solve).
"""

from __future__ import annotations

from work import PEAKS

# NVIDIA's H100 SXM data sheet: FP64 outside the tensor cores, dense
FP64_FLOPS = 34e12
KERNELS = ("k6_segments", "k6_interface", "k6_interiors")


def segments(n: int, q: int) -> tuple[int, int]:
    """(q_eff, B): the length and number of the SPIKE segments of a chain
    of n blocks; a chain of at most 2q blocks is one segment of n."""
    if n <= 2 * q:
        return n, 1
    return q, -(-n // q)


def k6_work(n: int, b: int, m: int, q: int,
            itemsize: int) -> tuple[float, float]:
    """(bytes, float64 operations) of one solve at (n, b, m, q) on
    panels of `itemsize` bytes an element."""
    qs, B = segments(n, q)
    qi, M, cube = qs - 1, m + 2 * b, 2 * b ** 3
    nbytes = itemsize * ((2 * n - 1) * b * b + 2 * n * b * m)
    ops = (B * qi * (cube + 6 * b * b * M)  # inverse, panel, back-substitution
           + B * max(qi - 1, 0) * 2 * cube  # L = O G and A - L O^T
           + B * (cube + 6 * b * b * m) + (B - 1) * 2 * cube  # interface
           + B * (6 * cube + 4 * b * b * m)  # the interface terms
           + B * (4 * b * b * m + qi * 4 * b * b * m))  # the interiors
    return float(nbytes), float(ops)


def roofline_share(ops: float, nbytes: float, seconds: float):
    """Percent of the roofline: the least time the card could take (the
    larger of the float64 operations over the FP64 peak and the bytes over
    the HBM bandwidth of peaks.json) over the measured device seconds;
    None without a measurement."""
    if not seconds or seconds <= 0:
        return None
    least = max(ops / FP64_FLOPS, nbytes / PEAKS["hbm_bytes_per_s"])
    return 100.0 * least / seconds
