"""K6 (block_tridiag: its segments, interface and interiors kernels)
share of its roofline in a revisit run's direct LM: the float64 work of
every call of the program's block_tridiag_solve in the profiled pass (b),
at the shape and element size of the panels it was handed
(work_tridiag.k6_work; run.work["k6"], recorded by the runner), over the
kernels' device seconds in that pass's trace; None where the pass made
no call or the trace holds no K6 kernel (the CPU)."""

import trace
import work_tridiag


def read(run):
    calls = run.work.get("k6") if run.trace is not None else None
    if not calls:
        return None
    secs = sum(trace.kernel_seconds(run.trace, name)[0]
               for name in work_tridiag.KERNELS)
    if secs <= 0:
        return None
    work = [work_tridiag.k6_work(*c) for c in calls]
    return work_tridiag.roofline_share(sum(w[1] for w in work),
                                       sum(w[0] for w in work), secs)
