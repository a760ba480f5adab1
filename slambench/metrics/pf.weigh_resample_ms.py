"""Host milliseconds a step in the weights, the estimate and the
branchless resample (float64 roundings): the program's pf.weigh_resample
spans over the traced steps with tracing on (spans.passes, pass (c)), over
the pf.step spans."""

import spans

STEP = "pf.step"


def read(run):
    out = (spans.passes(run) if run.work.get("runner") == "stream_pf"
           else None)
    if out is None or not spans.roots(out, STEP):
        return None
    return 1e3 * spans.seconds(out, "pf.weigh_resample", STEP) / spans.roots(
        out, STEP)
