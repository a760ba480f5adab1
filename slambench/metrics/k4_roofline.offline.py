"""K4 (nn_argmin) share of its roofline in an offline run: the work of
every ICP sweep (work.nn_work) over the kernel's device seconds in the
trace."""

import trace
import work


def read(run):
    if run.trace is None or run.work.get("runner") != "offline":
        return None
    secs, n = trace.kernel_seconds(run.trace, "nn_argmin_kernel")
    if not n:
        return None
    return work.roofline_share(*work.nn_work(run.work["nn_sweeps"]), secs)
