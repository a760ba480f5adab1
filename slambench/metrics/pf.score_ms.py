"""Host milliseconds a step in the particles' map-correlation score: the
program's pf.score spans over the traced steps with tracing on
(spans.passes, pass (c)), over the pf.step spans."""

import spans

STEP = "pf.step"


def read(run):
    out = (spans.passes(run) if run.work.get("runner") == "stream_pf"
           else None)
    if out is None or not spans.roots(out, STEP):
        return None
    return 1e3 * spans.seconds(out, "pf.score", STEP) / spans.roots(out,
                                                                    STEP)
