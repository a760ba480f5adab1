"""Float32 precision policy: full-precision matmuls everywhere.

The JAX package pins Precision.HIGHEST on every contraction because the
TPU's default bf16 passes corrupted Kabsch rotations enough to stall ICP
(lidar_slam_tpu/utils/precision.py). On an NVIDIA GPU the counterpart of
that default is TF32 (about three decimal digits), which PyTorch may use for
float32 matmuls and cuDNN convolutions. Every contraction on this pipeline
is small-K geometry (3x3 pose products, K=2/3 point transforms and distance
cross terms), where full float32 costs nothing, so TF32 is switched off
explicitly when this module is imported.

in_float64 rounds a transcendental or a reduction once from float64: the
CPU's and CUDA's float32 cos, sin, exp and sums can round a last bit apart
(other approximations, other summation orders), and a last bit moves a
ray endpoint across a cell boundary now and then.
"""

from __future__ import annotations

import torch


def apply() -> None:
    """Disable TF32 for matmuls and cuDNN; request full float32 matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def in_float64(fn, *args, **kwargs) -> torch.Tensor:
    """fn on float64 copies of the tensors `args`, rounded once back to the
    first one's dtype: the same value on the CPU and on CUDA, except at a
    float64 rounding tie."""
    return fn(*(a.double() for a in args), **kwargs).to(args[0].dtype)


apply()
