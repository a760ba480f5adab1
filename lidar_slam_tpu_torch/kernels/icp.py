"""Wrapper of K5, the tail of a planar ICP sweep (csrc/icp.cu).

icp_sweep_tail advances a batch's ICP carry (ops/icp.IcpCarry with its
src_t) by one sweep, in place, from K4's correspondences: the planar
Kabsch fit, the error at the previous transform, the stopping rules, the
correspondences and the sources under the new transform. It launches the
kernel for CUDA tensors; for CPU tensors it runs the kernel's plain
version, icp_sweep_tail_plain, which repeats the kernel's arithmetic in
PyTorch (float64 sums of raw moments, centred at the end). There is no
fallback from a CUDA tensor to the plain version: a launch failure raises.

No path of the port runs the plain version: ICP on CPU tensors takes
ops/icp's op-by-op sweep, which is also what the kernel is held to on the
card. The plain version is the kernel's arithmetic for the CPU tests.
"""

from __future__ import annotations

import torch

from . import build

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def icp_sweep_tail(src: torch.Tensor, matched: torch.Tensor,
                   idx: torch.Tensor, src_mask: torch.Tensor, carry,
                   normalize: bool, epsilon: float, max_iters: int,
                   stopping_thresh: float) -> None:
    """One sweep's tail for B pairs, written into `carry` in place.

    src (B, N, 3) float32 sources; matched (B, N, 3) and idx (B, N) int32,
    K4's answer for carry.src_t; src_mask (B, N) bool. carry: T (B, 4, 4),
    err, last_err, last_err2 (B,) float32, idx (B, N) int32, k (B,) int32,
    done (B,) bool and src_t (B, N, 3) float32, all contiguous on one
    device. A pair that is done is left as it is.
    """
    if not src.is_cuda:
        icp_sweep_tail_plain(src, matched, idx, src_mask, carry, normalize,
                             epsilon, max_iters, stopping_thresh)
        return
    if src.dim() != 3 or src.shape[2] != 3:
        raise ValueError(f"src must be (B, N, 3), got {tuple(src.shape)}")
    B, N, _ = src.shape
    index = src.get_device()
    for name, t, shape, dtype in (
            ("src", src, (B, N, 3), _F32),
            ("matched", matched, (B, N, 3), _F32),
            ("idx", idx, (B, N), _I32),
            ("src_mask", src_mask, (B, N), _BOOL),
            ("carry.src_t", carry.src_t, (B, N, 3), _F32),
            ("carry.T", carry.T, (B, 4, 4), _F32),
            ("carry.err", carry.err, (B,), _F32),
            ("carry.last_err", carry.last_err, (B,), _F32),
            ("carry.last_err2", carry.last_err2, (B,), _F32),
            ("carry.idx", carry.idx, (B, N), _I32),
            ("carry.k", carry.k, (B,), _I32),
            ("carry.done", carry.done, (B,), _BOOL)):
        if t.shape != shape or t.dtype is not dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {src.device}")
    _ICP_SWEEP_TAIL(index, src.data_ptr(), carry.src_t.data_ptr(),
                    matched.data_ptr(), idx.data_ptr(), src_mask.data_ptr(),
                    carry.T.data_ptr(), carry.err.data_ptr(),
                    carry.last_err.data_ptr(), carry.last_err2.data_ptr(),
                    carry.idx.data_ptr(), carry.k.data_ptr(),
                    carry.done.data_ptr(), B, N, int(normalize), epsilon,
                    max_iters, stopping_thresh)
    icp_sweep_tail.launches += 1


_ICP_SWEEP_TAIL = build.Entry("slam_icp_sweep_tail")
icp_sweep_tail.launches = 0
icp_sweep_tail.entry = _ICP_SWEEP_TAIL


def icp_sweep_tail_plain(src, matched, idx, src_mask, carry,
                         normalize: bool, epsilon: float, max_iters: int,
                         stopping_thresh: float) -> None:
    """icp_sweep_tail as the kernel computes it, on any device, in place."""
    c = carry
    live = ~c.done
    w = src_mask.double()
    s, t = c.src_t.double(), matched.double()
    n = w.sum(-1)
    wsum = torch.clamp(n, min=1e-12)[:, None]
    cs = (s[..., :2] * w[..., None]).sum(-2) / wsum
    ct = (t[..., :2] * w[..., None]).sum(-2) / wsum
    S = (torch.einsum("bn,bni,bnj->bij", w, s[..., :2], t[..., :2])
         - n[:, None, None] * cs[:, :, None] * ct[:, None, :])
    theta = torch.atan2((S[:, 0, 1] - S[:, 1, 0]).float(),
                        (S[:, 0, 0] + S[:, 1, 1]).float())
    co, si = torch.cos(theta), torch.sin(theta)
    csf, ctf = cs.float(), ct.float()
    F = torch.eye(4, dtype=_F32, device=src.device).repeat(len(co), 1, 1)
    F[:, 0, 0], F[:, 0, 1], F[:, 1, 0], F[:, 1, 1] = co, -si, si, co
    F[:, 0, 3] = ctf[:, 0] - (co * csf[:, 0] - si * csf[:, 1])
    F[:, 1, 3] = ctf[:, 1] - (si * csf[:, 0] + co * csf[:, 1])
    T_new = F @ c.T

    d2 = torch.sum((c.src_t - matched) ** 2, dim=-1)
    err = torch.sum(d2.double() * w, dim=-1).float()
    if normalize:
        m = src_mask[..., None]
        lo = torch.minimum(*(torch.where(m, x, torch.inf).amin(-2)
                             for x in (c.src_t, matched)))
        hi = torch.maximum(*(torch.where(m, x, -torch.inf).amax(-2)
                             for x in (c.src_t, matched)))
        err = err / (torch.sum((hi - lo) ** 2, dim=-1)
                     * torch.clamp(n, min=1).float())
    stop = ((err < epsilon) | (c.k >= max_iters)
            | (~torch.isinf(c.last_err)
               & (torch.abs(c.last_err - err) < stopping_thresh)))

    c.T.copy_(torch.where(live[:, None, None], T_new, c.T))
    c.err.copy_(torch.where(live, err, c.err))
    c.last_err2.copy_(torch.where(live, c.last_err, c.last_err2))
    c.last_err.copy_(torch.where(live, err, c.last_err))
    c.idx.copy_(torch.where(live[:, None], idx, c.idx))
    c.k.add_(live.to(c.k.dtype))
    stays = live & ~stop
    moved = (torch.einsum("bij,bnj->bni", c.T[:, :3, :3], src)
             + c.T[:, None, :3, 3])
    c.src_t.copy_(torch.where(stays[:, None, None], moved, c.src_t))
    c.done.copy_(c.done | (live & stop))
