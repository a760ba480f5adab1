"""PyTorch port of the 2-D LiDAR SLAM framework, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The JAX package (lidar_slam_tpu/) is the reference; this package mirrors its
layout (ops/, models/, utils/) and adds kernels/ (the build and the Python
wrappers) and csrc/ (the CUDA sources). It imports torch and numpy, never
JAX. Importing it applies the float32 precision policy in utils/precision.py.
"""

from .utils import precision as _precision  # noqa: F401  (applies the policy)
