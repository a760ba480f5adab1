"""Probe tools of the port: Hopper counterparts of the JAX package's TPU
probes, one module per tool (pallas_probe P1-P6, scatter_microbench P7-P8,
vpu_probe P9), each run as `python -m lidar_slam_tpu_torch.tools.<name>`.

They measure the card, so they run on a CUDA GPU only: without one they
exit with a nonzero status and a message (there is no CPU run of a
measurement). Each prints the card's `name, power.limit` first, then the
JAX tool's lines at the JAX tool's sizes; its run() returns the numbers as
a dict.
"""

from __future__ import annotations

import subprocess
import sys

import torch


def require_cuda(prog: str) -> None:
    """Exit with status 1 and a message when there is no CUDA device."""
    if not torch.cuda.is_available():
        sys.exit(f"{prog}: needs a CUDA GPU (torch.cuda.is_available() is "
                 "False); its measurements have no CPU run")


def card() -> str:
    """The card's `name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn) -> float:
    """Milliseconds of one fn() on the current stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)
