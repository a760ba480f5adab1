"""Hand-written CUDA kernels: the nvcc build (build.py) and one Python
wrapper per kernel. Each wrapper launches its kernel for CUDA tensors and
runs the kernel's plain PyTorch version for CPU tensors."""
