"""The construct probes P1-P6 on the card.

Replaces tools/pallas_probe.py (v1_smem_stream :38, v2_dynamic_store :64,
v3_dynamic_lane_store :92, v4_masked_tile :122, v5_vmem_scalar_read :159,
v6_full_grid_vmem :176). On the TPU each probe asked whether Mosaic
accepted one construct: a scalar stream from SMEM, dynamic sublane and
lane offsets, a masked tile RMW, a scalar read from VMEM, and the padded
map grid resident in VMEM. On Hopper every one of them is plain CUDA; what
the probes ask here is what each costs as one launch, and whether the grid
stays on chip (P6: its 5.9 MB exceed the 227 KB of shared memory a block
can use and fit the 50 MB L2, so the map kernels own tiles of it).

    python -m lidar_slam_tpu_torch.tools.pallas_probe

Each probe runs its kernel (kernels/probes.py) on the JAX tool's inputs
and prints PASS with the first values and the mean time of 100 launches
(CUDA events).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import probes
from . import card, events_ms, require_cuda

REPS = 100  # timed calls a measurement
W, H = probes.PROBE_SHAPE
CH = 32  # entries per grid step of the TPU kernels (two steps)

KERNELS = {  # the JAX tool's order of calls
    "v6_full_grid_vmem": probes.full_grid,
    "v1_smem_stream": probes.smem_stream,
    "v2_dynamic_store": probes.dynamic_store,
    "v3_dynamic_lane_store": probes.dynamic_lane_store,
    "v4_masked_tile": probes.masked_tile,
    "v5_vmem_scalar_read": probes.scalar_sum,
}


def inputs(name: str) -> tuple[np.ndarray, ...]:
    """The JAX tool's inputs of probe `name`, as numpy arrays."""
    rng = np.random.default_rng(0)
    if name == "v1_smem_stream":
        return (np.arange(2 * CH, dtype=np.float32),)
    if name == "v2_dynamic_store":
        return (rng.integers(0, W, 2 * CH).astype(np.int32),)
    if name in ("v3_dynamic_lane_store", "v4_masked_tile"):
        xs = rng.integers(0, W, 2 * CH).astype(np.int32)
        return xs, rng.integers(0, H, 2 * CH).astype(np.int32)
    if name == "v5_vmem_scalar_read":
        return (np.arange(CH, dtype=np.float32),)
    return ()


def call(name: str, device) -> torch.Tensor:
    """Probe `name` on its inputs on `device`: the kernel on the card, the
    plain version on the CPU."""
    args = [torch.as_tensor(a, device=device) for a in inputs(name)]
    return KERNELS[name](*(args or [device]))


def run(log=print) -> dict:
    """Each probe once, then REPS launches timed; returns
    {name: {"first": first four values, "ms": mean ms per launch}}."""
    dev = torch.device("cuda")
    res = {}
    for name, kernel in KERNELS.items():
        args = [torch.as_tensor(a, device=dev) for a in inputs(name)] or [dev]
        first = kernel(*args).flatten()[:4].tolist()

        def launches():
            for _ in range(REPS):
                kernel(*args)

        ms = events_ms(launches) / REPS
        log(f"PASS {name}: {first}  {ms:.4f} ms")
        res[name] = {"first": first, "ms": ms}
    mb = float(np.prod(probes.GRID_SHAPE)) * 4 / 1e6
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 0) / 1e6
    log(f"v6 grid {probes.GRID_SHAPE[0]}x{probes.GRID_SHAPE[1]} float32 = "
        f"{mb:.2f} MB: more than the 227 KB of shared memory a block can "
        f"use; {'fits' if mb < l2 else 'exceeds'} the {l2:.1f} MB L2")
    return res


def main() -> int:
    require_cuda("pallas_probe")
    print(card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
