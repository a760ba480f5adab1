"""Build the CUDA kernels in csrc/ with nvcc and load them with ctypes.

All csrc/*.cu sources compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/libslamkernels_<hash>.so csrc/*.cu

The library is written under build/kernels/ at the repository root at
first use, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file. Nothing here runs at
import time: this module imports on hosts without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC"]


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslamkernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet. Returns (path, seconds
    spent compiling; 0.0 when an existing build was reused)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's C signature
    declared (pointers and the stream as c_void_p, sizes as c_int)."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.slam_nn_argmin.argtypes = [p, p, p, i, i, i, i, p, p, p]
    lib.slam_nn_argmin.restype = i
    lib.slam_raywalk_build.argtypes = [p, p, i, i, i, i, i, f, f, p, p]
    lib.slam_raywalk_build.restype = i
    return lib
