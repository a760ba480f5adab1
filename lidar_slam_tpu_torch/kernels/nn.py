"""Wrapper of the Hopper nearest-neighbour kernel (csrc/nn.cu).

nn_argmin launches the kernel for CUDA tensors; for CPU tensors it runs the
kernel's plain version (ops/nn.nearest_neighbors plus a gather). There is
no fallback from a CUDA tensor to the plain version: a build or launch
failure raises.

nn_argmin_rounded repeats the kernel's arithmetic op by op, so the
kernel's indices equal it exactly where the plain version's matmul may
round a cross term differently. It is the kernel's exactness oracle for
the tests and chip_smoke.py, and no path of the port calls it.
"""

from __future__ import annotations

import torch

from ..ops.nn import BIG, gather_points, nearest_neighbors
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
    if src.dtype is not torch.float32 or tgt.dtype is not torch.float32:
        raise ValueError(f"nn_argmin kernel takes float32, got {src.dtype}, "
                         f"{tgt.dtype}")
    if M == 0:
        raise ValueError("nn_argmin needs at least one target point")
    if tgt_mask is None:
        tgt_mask = torch.ones((B, M), dtype=torch.bool, device=src.device)
    if tgt_mask.shape != (B, M) or tgt_mask.dtype is not torch.bool:
        raise ValueError(f"tgt_mask must be ({B}, {M}) bool")
    index = src.get_device()
    if not (tgt.get_device() == index == tgt_mask.get_device()):
        raise ValueError("src, tgt and tgt_mask must be on one device")
    if not (src.is_contiguous() and tgt.is_contiguous()
            and tgt_mask.is_contiguous()):
        raise ValueError("src, tgt and tgt_mask must be contiguous")
    dev = src.device
    idx = torch.empty((B, N), dtype=torch.int32, device=dev)
    matched = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    _NN_ARGMIN(index, src.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(), B,
               N, M, D, idx.data_ptr(), matched.data_ptr())
    nn_argmin.launches += 1
    return idx, matched


_NN_ARGMIN = build.Entry("slam_nn_argmin")
nn_argmin.launches = 0
nn_argmin.entry = _NN_ARGMIN


def nn_argmin_rounded(src: torch.Tensor, tgt: torch.Tensor,
                      tgt_mask: torch.Tensor | None = None):
    """(idx, matched) as the kernel computes them, on any device.

    Each product and sum is its own float32 op, in the kernel's order:
    |t|^2 = (tx*tx + ty*ty) + tz*tz, s.t = (sx*tx + sy*ty) + sz*tz and
    d = |t|^2 - 2 (s.t); masked targets are replaced by 1e30 and the row
    argmin takes the first minimum. It holds the (B, N, M) distances in
    memory, several times over."""
    D = src.shape[-1]
    t2 = tgt[..., 0] * tgt[..., 0]
    for k in range(1, D):
        t2 = t2 + tgt[..., k] * tgt[..., k]
    dot = src[..., :, None, 0] * tgt[..., None, :, 0]
    for k in range(1, D):
        dot = dot + src[..., :, None, k] * tgt[..., None, :, k]
    d = t2[..., None, :] - 2.0 * dot
    if tgt_mask is not None:
        d = torch.where(tgt_mask[..., None, :], d, torch.full_like(d, BIG))
    idx = torch.argmin(d, dim=-1).to(torch.int32)
    return idx, gather_points(tgt, idx)
