"""Run one cell of the benchmark once.

    python3 slambench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (it exits non-zero, printing no result, without them). The last
line of standard output is the result as one JSON object; the numbers the
correctness check compared, each with its limit, are the last lines of
standard error and the result's last key, "compared".
"""

import os
import sys

# One process with few threads: no BLAS or OpenMP pool beside the loop
# that drives the card.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
