"""Wrapper of the Hopper nearest-neighbour kernel (csrc/nn.cu).

nn_argmin launches the kernel for CUDA tensors; for CPU tensors it runs the
kernel's plain version (ops/nn.nearest_neighbors plus a gather). There is
no fallback from a CUDA tensor to the plain version: a build or launch
failure raises.
"""

from __future__ import annotations

import torch

from ..ops.nn import gather_points, nearest_neighbors
from . import build


def nn_argmin(src: torch.Tensor, tgt: torch.Tensor,
              tgt_mask: torch.Tensor | None = None):
    """Nearest valid target of every source point, and that target.

    src (B, N, D), tgt (B, M, D), tgt_mask (B, M) bool (None: all valid).
    Returns idx (B, N) int32 (lowest index on exact ties) and matched
    (B, N, D) = tgt[idx]. The kernel takes float32 and D in {2, 3}.
    """
    if not src.is_cuda:
        idx = nearest_neighbors(src, tgt, tgt_mask)
        return idx, gather_points(tgt, idx)
    if src.dim() != 3 or tgt.dim() != 3:
        raise ValueError("src and tgt must be (B, N, D) and (B, M, D)")
    B, N, D = src.shape
    M = tgt.shape[1]
    if tgt.shape[0] != B or tgt.shape[2] != D or D not in (2, 3):
        raise ValueError(f"shape mismatch: src {tuple(src.shape)}, "
                         f"tgt {tuple(tgt.shape)} (D must be 2 or 3)")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32:
        raise ValueError(f"nn_argmin kernel takes float32, got {src.dtype}, "
                         f"{tgt.dtype}")
    if M == 0:
        raise ValueError("nn_argmin needs at least one target point")
    if tgt_mask is None:
        tgt_mask = torch.ones((B, M), dtype=torch.bool, device=src.device)
    if tgt_mask.shape != (B, M) or tgt_mask.dtype != torch.bool:
        raise ValueError(f"tgt_mask must be ({B}, {M}) bool")
    if not (tgt.device == src.device == tgt_mask.device):
        raise ValueError("src, tgt and tgt_mask must be on one device")
    if not (src.is_contiguous() and tgt.is_contiguous()
            and tgt_mask.is_contiguous()):
        raise ValueError("src, tgt and tgt_mask must be contiguous")
    idx = torch.empty((B, N), dtype=torch.int32, device=src.device)
    matched = torch.empty((B, N, D), dtype=torch.float32, device=src.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.slam_nn_argmin(src.data_ptr(), tgt.data_ptr(),
                                tgt_mask.data_ptr(), B, N, M, D,
                                idx.data_ptr(), matched.data_ptr(), stream)
        nn_argmin.launches += 1
    if rc != 0:
        raise RuntimeError(f"nn_argmin kernel launch failed: CUDA error {rc}")
    return idx, matched


nn_argmin.launches = 0
