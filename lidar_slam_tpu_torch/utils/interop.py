"""Moving the system's state between numpy and the port's tensors.

The system has no weights: its state is the dataset arrays, pose
trajectories, PoseGraph fields and an optional initial log-odds grid. The
JAX package hands these around as numpy arrays, dicts and NamedTuples;
from_numpy/to_numpy convert whole structures, keeping each array's dtype
unless one is forced, so parity tests feed both packages the same values.
"""

from __future__ import annotations

import numpy as np
import torch

_SCALARS = (int, float, bool, str, type(None))


def from_numpy(obj, device="cpu", dtype: torch.dtype | None = None):
    """numpy arrays (inside dicts, lists, tuples, NamedTuples) -> tensors on
    `device`. dtype, when given, applies to floating arrays only (integer
    and bool arrays keep theirs); numpy scalars become 0-d tensors, Python
    scalars pass through."""
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)  # keeps 0-d arrays 0-d
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = np.array(a, order="C")  # e.g. a view of a JAX array
        t = torch.from_numpy(a).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    if isinstance(obj, torch.Tensor):
        t = obj.to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    if isinstance(obj, dict):
        return {k: from_numpy(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(from_numpy(v, device, dtype) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_numpy(v, device, dtype) for v in obj)
    if isinstance(obj, _SCALARS):
        return obj
    raise TypeError(f"from_numpy: unsupported type {type(obj).__name__}")


def to_numpy(obj):
    """Tensors (inside dicts, lists, tuples, NamedTuples) -> numpy arrays on
    the host, dtypes kept."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    if isinstance(obj, (np.ndarray, np.generic) + _SCALARS):
        return obj
    raise TypeError(f"to_numpy: unsupported type {type(obj).__name__}")


def carry_pf_state(state, generator: torch.Generator, device="cpu"):
    """The JAX package's PFState or PFSlamState as the port's, on `device`.

    Every array field is handed over through numpy (np.asarray); the JAX
    PRNG key, which no torch generator continues, is replaced by
    `generator` (on `device`). A state with a `logodds` field becomes a
    PFSlamState, else a PFState. Lets two runs, one per package, start
    from one state."""
    from ..models.particle_filter import PFState
    from ..models.pf_slam import PFSlamState

    if generator.device.type != torch.device(device).type:
        raise ValueError(f"generator is on {generator.device}, the state "
                         f"goes to {device}")
    fields = state._asdict()
    arrays = {k: from_numpy(np.asarray(v), device)
              for k, v in fields.items() if k != "key"}
    if "logodds" in fields:
        return PFSlamState(generator=generator, **arrays)
    return PFState(generator=generator, **arrays)


def carry_clamp_affine(f, device="cpu"):
    """A clamp-affine triple (a, lo, hi) of numpy arrays (the JAX
    package's ClampAffine through np.asarray, or any 3-tuple) as the
    port's ops/clamp_affine.ClampAffine on `device`, dtypes kept."""
    from ..ops.clamp_affine import ClampAffine

    a, lo, hi = (from_numpy(np.asarray(v), device) for v in f)
    return ClampAffine(a=a, lo=lo, hi=hi)
