"""P9 word tables whose visits land on chosen tiles, for the tests: the
probe tool's table (tools/vpu_probe.words_for) with the tile field of its
visit words drawn anew."""

import numpy as np


def retile(words: np.ndarray, tiles, seed: int) -> np.ndarray:
    """A copy of `words` whose visit words (rows 1 and 3) keep their low 15
    bits and take a tile field (w2 >> 15) with its tile row drawn from
    tiles[0] and its lane tile from tiles[1], each a (lo, hi) range (lane
    tiles below 16)."""
    (r_lo, r_hi), (c_lo, c_hi) = tiles
    r = np.random.default_rng(seed)
    w = words.copy()
    n = w.shape[1]
    for row in (1, 3):
        tile = r.integers(c_lo, c_hi, n) | (r.integers(r_lo, r_hi, n) << 4)
        w[row] = (w[row] & 0x7FFF) | (tile << 15)
    return w
