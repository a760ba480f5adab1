"""The host's side of a kernel launch: P1-P6 and K4 at B = 1 on the card.

Below about 0.02 ms a wrapper's time by CUDA events is its host path, not
its kernel (P5 spends about 0.0012 ms on an H100). This tool splits that
path by the host clock, over calls that only enqueue (one synchronize
after them; the median of ROUNDS rounds of REPS calls): the whole
wrapper, its output allocation (torch.empty of what it returns), its C
entry point through ctypes alone, and the rest, its Python (checks, the
launch path). The C entry is called with the very arguments and stream
the wrapper passed it, recorded from one wrapper call through the
wrapper's build.Entry (its .entry), so its argument list lives only in
the wrapper. The tool also times the wrapper a call by CUDA events, and
one PyTorch call of each kind the wrappers are timed against: `sum` (P5's
library call), `index_add_` into a zero grid (P1-P4's) and `torch.ones`
(P6's).

    python -m lidar_slam_tpu_torch.tools.host_split
"""

from __future__ import annotations

import statistics
import time

import torch

from ..kernels import probes
from ..kernels.nn import nn_argmin
from . import card, events_ms, pallas_probe, require_cuda, scatter_microbench

REPS = 200  # calls a round of a measurement
ROUNDS = 7  # rounds a measurement, its median kept (the host's noise)
NN_B1 = (1, 1081, 1081)  # K4 on the online path: one scan pair


def host_us(fn) -> float:
    """Host microseconds a call of fn: the median of ROUNDS rounds of REPS
    calls that only enqueue (each after a synchronize, one after them)."""
    fn()
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        rounds.append((time.perf_counter() - t0) / REPS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(rounds)


def events_us(fn) -> float:
    """Microseconds a call of fn by CUDA events: the median of ROUNDS
    rounds of REPS calls (after one call and a synchronize)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(REPS):
            fn()

    return statistics.median(events_ms(calls) / REPS * 1e3
                             for _ in range(ROUNDS))


def _parts(call, entry, dev):
    """(allocation, C entry call) of a wrapper call that launches through
    build.Entry `entry`: torch.empty of what the call returns, and the
    entry's ctypes function on the arguments and stream that one call
    passed it (which keeps that call's output alive)."""
    call()  # binds the entry's ctypes function
    fn, seen = entry._fn, []
    entry._fn = lambda *args: seen.append(args) or fn(*args)
    try:
        out = call()
    finally:
        entry._fn = fn
    (args,) = seen
    if isinstance(out, torch.Tensor):
        shape, dtype = out.shape, out.dtype

        def empty():
            return torch.empty(shape, dtype=dtype, device=dev)
    else:
        (s0, d0), (s1, d1) = ((o.shape, o.dtype) for o in out)

        def empty():
            return (torch.empty(s0, dtype=d0, device=dev),
                    torch.empty(s1, dtype=d1, device=dev))

    def alone(out=out):  # holds the output: the recorded pointers stay valid
        return fn(*args)

    return empty, alone


def split() -> dict:
    """{label: {"call", "empty", "entry", "python"} host us, and "events"
    us by CUDA events} for each P1-P6 wrapper (its name) and
    "nn_argmin_b1", and under "library" {label: {"call", "events"}} of the
    library calls."""
    dev = torch.device("cuda")
    calls = {}
    for name, fn in pallas_probe.KERNELS.items():
        args = [torch.as_tensor(a, device=dev)
                for a in pallas_probe.inputs(name)] or [dev]
        calls[fn.__name__] = (lambda fn=fn, args=args: fn(*args), fn.entry)
    B, N, M = NN_B1
    g = torch.Generator().manual_seed(0)
    src = torch.randn((B, N, 3), generator=g).to(dev)
    tgt = torch.randn((B, M, 3), generator=g).to(dev)
    mask = (torch.rand((B, M), generator=g) > 0.1).to(dev)
    calls["nn_argmin_b1"] = (lambda: nn_argmin(src, tgt, mask),
                             nn_argmin.entry)
    res = {}
    for label, (call, entry) in calls.items():
        empty, alone = _parts(call, entry, dev)
        t = {"call": host_us(call), "empty": host_us(empty),
             "entry": host_us(alone)}
        t["python"] = t["call"] - t["empty"] - t["entry"]
        t["events"] = events_us(call)
        res[label] = t
    xs5 = torch.as_tensor(pallas_probe.inputs("v5_vmem_scalar_read")[0],
                          device=dev)
    g3 = [torch.as_tensor(a, device=dev)
          for a in pallas_probe.inputs("v3_dynamic_lane_store")]
    flat, vals = probes.adds(probes.dynamic_lane_store, *g3)
    library = {
        "sum": lambda: xs5.sum(),
        "index_add_": lambda: scatter_microbench.index_add(
            flat, vals, probes.PROBE_SHAPE),
        "torch.ones": lambda: torch.ones(probes.GRID_SHAPE, device=dev)}
    res["library"] = {label: {"call": host_us(fn), "events": events_us(fn)}
                      for label, fn in library.items()}
    return res


def lines(res: dict) -> list[str]:
    """One printed line a wrapper, then the library calls."""
    out = [f"{label}: {t['call']:.2f} = torch.empty {t['empty']:.2f} + the "
           f"C entry through ctypes {t['entry']:.2f} + Python "
           f"{t['python']:.2f}; CUDA events {t['events']:.2f}"
           for label, t in res.items() if label != "library"]
    out.append("library (host clock, CUDA events): " + ", ".join(
        f"{k} {t['call']:.2f}, {t['events']:.2f}"
        for k, t in res["library"].items()))
    return out


def run(log=print) -> dict:
    """split() on the card, each line logged; returns split()'s dict."""
    res = split()
    log(f"us a call by the host clock (calls that only enqueue) and by "
        f"CUDA events, medians of {ROUNDS} rounds of {REPS} calls; "
        f"nn_argmin_b1 at B, N, M = {NN_B1}:")
    for line in lines(res):
        log(f"  {line}")
    return res


def main() -> int:
    require_cuda("host_split")
    print(card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
