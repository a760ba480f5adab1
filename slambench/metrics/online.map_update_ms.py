"""Host milliseconds a step in the causal map update (the ray ends and
K2): the program's online.map_update spans over the traced steps with
tracing on (spans.passes, pass (c)), over the steps."""

import spans

STEP = "online.step"


def read(run):
    out = (spans.passes(run) if run.work.get("runner") == "stream_slam"
           else None)
    if out is None or not spans.roots(out, STEP):
        return None
    return 1e3 * spans.seconds(out, "online.map_update", STEP) / spans.roots(
        out, STEP)
