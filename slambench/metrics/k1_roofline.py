"""K1 (raywalk_build: binning and walk kernels) share of its roofline in
an offline run's map build (work.raywalk_work over a fresh grid)."""

import trace
import work


def read(run):
    k = run.work.get("k1") if run.trace is not None else None
    if not k:
        return None
    secs = sum(trace.kernel_seconds(run.trace, name)[0]
               for name in ("raywalk_bin_kernel", "raywalk_walk_kernel"))
    ops, nbytes = work.raywalk_work(k["scans"], k["rays"], k["width"],
                                    k["height"], k["visits"], grid_in=False)
    return work.roofline_share(ops, nbytes, secs)
