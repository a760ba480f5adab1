"""Build the CUDA kernels in csrc/ with nvcc and load them with ctypes.

All csrc/*.cu sources compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Every source
compiles in its own nvcc process, all started together, and one more links
the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <tmp>/<name>.o   # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/kernels/libslamkernels_<hash>.so <tmp>/*.o

The library is written under build/kernels/ at the repository root at
first use, named by a hash of the flags and of every file under csrc/
(headers included), so an edited source rebuilds and an unchanged one
loads the existing file. Nothing here runs at
import time: this module imports on hosts without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# torch's private bindings for the current device's index and the current
# raw stream of a device index
RAW_CUDA = ("_cuda_getDevice", "_cuda_getCurrentRawStream")


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
    for src in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(src.relative_to(CSRC_DIR).as_posix().encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslamkernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds: list[list[str]]) -> None:
    """Run the nvcc commands at once; raise with the output of the first
    that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


@functools.lru_cache(maxsize=1)
def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet. Returns (path, seconds
    spent compiling; 0.0 when an existing build was reused)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        _nvcc_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                   for src, obj in zip(sources(), objs)])
        lib = Path(tmp) / out.name
        _nvcc_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                    *map(str, objs)]])
        os.replace(lib, out)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's C signature
    declared (pointers and the stream as c_void_p, sizes as c_int)."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_longlong
    lib.slam_nn_argmin.argtypes = [p, p, p, i, i, i, i, p, p, p]
    lib.slam_nn_argmin.restype = i
    lib.slam_raywalk_bin.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
    lib.slam_raywalk_bin.restype = i
    lib.slam_raywalk_walk.argtypes = [p, p, p, i, i, i, i, i, f, f, p, p]
    lib.slam_raywalk_walk.restype = i
    lib.slam_raywalk_scan.argtypes = [p, p, i, i, i, i, f, f, i, p, p]
    lib.slam_raywalk_scan.restype = i
    lib.slam_icp_sweep_tail.argtypes = [p] * 12 + [i, i, i, f, i, f, p]
    lib.slam_icp_sweep_tail.restype = i
    lib.slam_block_tridiag.argtypes = [p] * 5 + [i64] + [i] * 5 + [p]
    lib.slam_block_tridiag.restype = i
    lib.slam_block_tridiag_scratch.argtypes = [i, i, i, i]
    lib.slam_block_tridiag_scratch.restype = i64
    # csrc/factors.cu, K7: the leading pointer, the graph (8 pointers, 4
    # ints, delta), the dtype flag, then each entry's own arguments
    graph = [p] * 9 + [i] * 4 + [ctypes.c_double, i]
    lib.slam_factors_linearize.argtypes = graph + [p, p]
    lib.slam_factors_banded_system.argtypes = (graph + [p] * 6 + [i, i]
                                               + [p] * 4)
    lib.slam_factors_cost.argtypes = graph + [p, p]
    for name in ("slam_factors_linearize", "slam_factors_banded_system",
                 "slam_factors_cost"):
        getattr(lib, name).restype = i
    probes = {  # csrc/probes.cu, P1-P9
        "slam_probe_smem_stream": [p, i, p, i, i, p],
        "slam_probe_dynamic_store": [p, i, p, i, i, p],
        "slam_probe_dynamic_lane_store": [p, p, i, p, i, i, p],
        "slam_probe_masked_tile": [p, p, i, f, p, i, i, p],
        "slam_probe_scalar_sum": [p, i, p, p],
        "slam_probe_fill": [p, i64, f, p],
        "slam_probe_tile_rmw": [p, p, p, i, p, i, i, p, i64, p],
        "slam_probe_segment_rmw": [p, p, p, p, i, f, p, i, i, p],
        "slam_probe_vpu_loop": [p, i, i, i, i, f, p, i, i, p],
    }
    for name, argtypes in probes.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i
    lib.slam_probe_tile_rmw_scratch.argtypes = [i, i, i]
    lib.slam_probe_tile_rmw_scratch.restype = i64
    return lib


@functools.lru_cache(maxsize=1)
def cuda_raw():
    """(get_device, raw_stream): get_device() is the current device's index
    and raw_stream(index) the handle of that device's current stream, as
    int, from torch's private bindings (RAW_CUDA). Entry calls them on
    every launch: torch.cuda.current_stream(i).cuda_stream builds a
    torch.cuda.Stream object each time, which costs host time. Private
    names can change between torch releases, so this is the one place that
    reads them: it raises, naming what is missing, where this torch lacks
    one (a CPU-only build lacks both)."""
    missing = [name for name in RAW_CUDA if not hasattr(torch._C, name)]
    if missing:
        raise RuntimeError(
            f"torch {torch.__version__} has no torch._C."
            f"{', torch._C.'.join(missing)}: the kernel wrappers need "
            f"{' and '.join(RAW_CUDA)} (a CUDA build of torch that still "
            f"has them)")
    return tuple(getattr(torch._C, name) for name in RAW_CUDA)


class Entry:
    """One C entry point of the library, as every kernel wrapper launches
    it: entry(index, *args) calls it with args and the raw handle of the
    current stream of device `index` (the tensors' t.get_device()), and
    raises if it returns a CUDA error.

    The entry point and cuda_raw's two readers are bound at the first
    launch, not on every call; a launch on the current device is then two
    calls into torch's C bindings and the ctypes call. The current device
    is switched (torch.cuda.device) only for tensors on another one."""

    __slots__ = ("name", "_fn", "_get_device", "_raw_stream")

    def __init__(self, name: str):
        self.name = name
        self._fn = None

    def __call__(self, index: int, *args) -> None:
        if self._fn is None:
            self._fn = getattr(library(), self.name)
            self._get_device, self._raw_stream = cuda_raw()
        if index == self._get_device():
            rc = self._fn(*args, self._raw_stream(index))
        else:
            with torch.cuda.device(index):
                rc = self._fn(*args, self._raw_stream(index))
        if rc:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
