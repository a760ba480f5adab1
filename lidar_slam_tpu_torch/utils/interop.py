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
        a = np.ascontiguousarray(obj)
        if not a.flags.writeable:  # e.g. a view of a JAX array
            a = a.copy()
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
