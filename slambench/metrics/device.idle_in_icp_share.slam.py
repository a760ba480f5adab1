"""Share of the device's idle time spent while the host was in the
program's ICP loop: 100 x idle seconds inside icp.batch spans / idle
seconds, over the online SLAM cell's traced steps profiled with tracing on
(spans.passes, pass (d))."""

import spans


def read(run):
    out = (spans.passes(run) if run.work.get("runner") == "stream_slam"
           else None)
    if out is None or out["idle_s"] <= 0:
        return None
    return 100.0 * out["idle_in"].get("icp.batch", 0.0) / out["idle_s"]
