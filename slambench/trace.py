"""The traced run: torch.profiler over a span of fixed work, reduced to
what the per-layer metrics and the result's breakdown read.

reduce() takes the profiler's events and returns
  busy_s     seconds in which some operation ran on the device (the union
             of the device events' intervals) within the window span;
  window_s   the window span's length on the profiler's clock;
  kernels    {device op name: [seconds, count]};
  launches   device kernels launched (memory copies and sets excluded);
  breakdown  the ten device ops that took the most time, and the ten
             largest sums of idle gaps by what the host was doing, each
             gap named by the deepest host op running at its middle, or by
             the host op that started next.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

WINDOW = "bench.window"


def traced(fn, dev):
    """(fn()'s value, reduce()'s result) with fn run under the profiler
    inside a WINDOW span, the device synchronized before the span ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            host_s = time.perf_counter() - t0
    red = reduce(prof.events())
    red["host_window_s"] = host_s
    return out, red


def short(name: str) -> str:
    """A device op's name without namespaces, "void " and arguments
    (kernels keep their template arguments), at most 120 characters."""
    for junk in ("(anonymous namespace)::", "at::native::", "void "):
        name = name.replace(junk, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:120].strip()


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce(events) -> dict:
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW
           and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    thread = win[0].thread
    dev, host = [], []
    kernels = defaultdict(lambda: [0.0, 0])
    launches = 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("bench."):  # the span's mark on the device
                continue
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            k = kernels[short(e.name)]
            k[0] += (b - a) * 1e-6
            k[1] += 1
            launches += not _is_copy(e.name)
        elif (e.device_type == DeviceType.CPU and e.thread == thread
              and e.name != WINDOW and b > a):
            host.append((a, -b, e.name))
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    gap_by = defaultdict(float)
    stack, nxt = [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt][0] <= mid:
            s, neg_end, name = host[nxt]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((-neg_end, name))
            nxt += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        if stack:
            label = stack[-1][1]
        else:
            j = bisect.bisect_right(starts, mid)
            label = ("before " + host[j][2]) if j < len(host) else "idle"
        gap_by[label] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    gtop = sorted(gap_by.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": (w1 - w0) * 1e-6,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "launches": launches,
            "breakdown": {"device_ops": [[k, v[0]] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in gtop]}}


def kernel_seconds(tr: dict, needle: str) -> tuple[float, int]:
    """(device seconds, launches) of the device ops whose name holds
    needle."""
    hits = [v for k, v in tr["kernels"].items() if needle in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)
