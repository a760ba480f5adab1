"""ctypes bindings of the port's host C++ runtime (csrc_host/).

Counterpart of lidar_slam_tpu/utils/native.py, over the port's own copy of
its sources, in two libraries:

  - csrc_host/slamhost.cpp (needs only -lpthread): project_frames, the
    texture's native projector; kdtree_query, an exact KD-tree; dbscan, an
    exact DBSCAN. A failed build raises with the compiler's output.
  - csrc_host/slampng.cpp (needs libpng): read_png and the threaded batch
    loader read_png_batch. Where it does not build, png_available() is
    False and utils/png.read_png decodes in Python (the same bytes).

Each library is built with g++ at first use into build/host/ at the
repository root, named by a hash of the compiler flags, the libraries
linked and the source: every build writes into a temporary directory of its
own and moves the file into place with os.replace, so processes that build
at once (the tests' workers) each end with a whole library. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc_host"
BUILD_DIR = PKG_DIR.parent / "build" / "host"
CXX_FLAGS = ["-O3", "-fno-math-errno", "-fno-trapping-math", "-fPIC",
             "-std=c++17", "-Wall", "-shared"]
LIBS = {"slamhost": ["-lpthread"], "slampng": ["-lpng", "-lz", "-lpthread"]}


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS[name]).encode())
    h.update((CSRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile lib<name> if it is not built yet; raise with g++'s output
    when it fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        cmd = ["g++", *CXX_FLAGS, str(CSRC_DIR / f"{name}.cpp"), "-o",
               str(lib), *LIBS[name]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(lib, out)
    return out


P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
D, F = ctypes.c_double, ctypes.c_float


@functools.lru_cache(maxsize=1)
def host_library() -> ctypes.CDLL:
    """libslamhost, built if needed, with its C signatures declared."""
    lib = ctypes.CDLL(str(build("slamhost")))
    lib.slamio_kdtree_build.argtypes = [P, I, I]
    lib.slamio_kdtree_build.restype = P
    lib.slamio_kdtree_query.argtypes = [P, P, I, P, P]
    lib.slamio_kdtree_query.restype = None
    lib.slamio_kdtree_free.argtypes = [P]
    lib.slamio_kdtree_free.restype = None
    lib.slamio_dbscan.argtypes = [P, I, I, F, I, P]
    lib.slamio_dbscan.restype = I
    lib.slamio_project_frames.argtypes = [P, P, P, I, I, I, P, D, D, D, I, I,
                                          P, P, P, I64, I]
    lib.slamio_project_frames.restype = I
    return lib


@functools.lru_cache(maxsize=1)
def png_library() -> ctypes.CDLL | None:
    """libslampng with its C signatures declared, or None where it does
    not build (no png.h or libpng on this host)."""
    try:
        lib = ctypes.CDLL(str(build("slampng")))
    except (RuntimeError, OSError):
        return None
    info = ctypes.POINTER(I)
    lib.slamio_read_png_info.argtypes = [ctypes.c_char_p, info, info, info,
                                         info]
    lib.slamio_read_png_info.restype = I
    for depth in ("u8", "u16"):
        one = getattr(lib, f"slamio_read_png_{depth}")
        one.argtypes = [ctypes.c_char_p, P]
        one.restype = I
        batch = getattr(lib, f"slamio_read_png_batch_{depth}")
        batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), I, P, I64,
                          ctypes.POINTER(I), I]
        batch.restype = I
    return lib


def png_available() -> bool:
    """True where the native PNG decoder builds and loads."""
    return png_library() is not None


def _png() -> ctypes.CDLL:
    lib = png_library()
    if lib is None:
        raise RuntimeError("the native PNG decoder did not build (libpng "
                           "missing?): use utils/png.read_png")
    return lib


def png_info(path: str):
    """(height, width, channels, bit depth) of a PNG's header."""
    lib = _png()
    w, h, c, depth = (I() for _ in range(4))
    rc = lib.slamio_read_png_info(path.encode(), ctypes.byref(w),
                                  ctypes.byref(h), ctypes.byref(c),
                                  ctypes.byref(depth))
    if rc != 0:
        raise IOError(f"native PNG info failed for {path} (rc={rc})")
    return h.value, w.value, c.value, depth.value


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H, W[, C]) uint8, or uint16 for 16-bit samples."""
    lib = _png()
    h, w, c, depth = png_info(path)
    shape = (h, w) if c == 1 else (h, w, c)
    out = np.empty(shape, dtype=np.uint16 if depth == 16 else np.uint8)
    fn = lib.slamio_read_png_u16 if depth == 16 else lib.slamio_read_png_u8
    rc = fn(path.encode(), out.ctypes.data_as(P))
    if rc != 0:
        raise IOError(f"native PNG decode failed for {path} (rc={rc})")
    return out


def read_png_batch(paths, shape, dtype, n_threads: int = 4) -> np.ndarray:
    """Decode same-shaped PNGs on the native thread pool: (N, *shape) of
    dtype np.uint8 or np.uint16, shape (H, W[, C]). Every header is read
    first (the decoder writes a whole image into its slot, so a larger file
    must not reach it); raises on the first file that differs or fails."""
    lib = _png()
    exp = (shape[0], shape[1], shape[2] if len(shape) == 3 else 1,
           16 if dtype == np.uint16 else 8)
    for path in paths:
        got = png_info(path)
        if got != exp:
            raise ValueError(f"{path}: image ({got[0]}x{got[1]}x{got[2]}@"
                             f"{got[3]}bit) does not match expected {shape} "
                             f"@ {exp[3]}bit")
    n = len(paths)
    out = np.empty((n,) + tuple(shape), dtype=dtype)
    rcs = (I * n)()
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fn = (lib.slamio_read_png_batch_u16 if dtype == np.uint16
          else lib.slamio_read_png_batch_u8)
    fn(c_paths, n, out.ctypes.data_as(P), int(np.prod(shape)), rcs,
       n_threads)
    for path, rc in zip(paths, rcs):
        if rc != 0:
            raise IOError(f"native PNG decode failed for {path} (rc={rc})")
    return out


def kdtree_query(target: np.ndarray, queries: np.ndarray):
    """Exact nearest neighbour of each query in `target` by the native
    KD-tree: target (M, D), queries (N, D) -> (idx (N,) int32, d2 (N,)
    float32 squared distances summed in float64). Ties go to the lowest
    target index, as ops/nn.py's argmin."""
    lib = host_library()
    target = np.ascontiguousarray(target, dtype=np.float32)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    if (target.ndim != 2 or queries.ndim != 2
            or target.shape[1] != queries.shape[1]):
        raise ValueError(f"shape mismatch: target {target.shape}, "
                         f"queries {queries.shape}")
    m, d = target.shape
    n = queries.shape[0]
    handle = lib.slamio_kdtree_build(target.ctypes.data_as(P), m, d)
    if not handle:
        raise RuntimeError(f"kdtree build failed for shape {target.shape}")
    try:
        idx = np.empty(n, dtype=np.int32)
        d2 = np.empty(n, dtype=np.float32)
        lib.slamio_kdtree_query(handle, queries.ctypes.data_as(P), n,
                                idx.ctypes.data_as(P), d2.ctypes.data_as(P))
    finally:
        lib.slamio_kdtree_free(handle)
    return idx, d2


def project_frames(disp: np.ndarray, rgb: np.ndarray, poses: np.ndarray,
                   cam_cfg, map_cfg, n_threads: int = 0):
    """A batch of RGB-D frames as last-writer-wins paint ops, by the
    texture's unproject chain in C++ double precision (reference:
    modules/texture_mapping.py:134-224).

    disp (B, H, W) uint16, rgb (B, H, W, 3) uint8, poses (B, 3). Returns
    (cells (M,) int32 linear indices into the width x height grid, colors
    (M,) int32 packed r | g << 8 | b << 16): each frame's cells once, with
    their last pixel's color, frames in order. n_threads = 0 takes one
    worker a core, at most 8; the result is the same for any count."""
    lib = host_library()
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    disp = np.ascontiguousarray(disp, dtype=np.uint16)
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    poses = np.ascontiguousarray(poses, dtype=np.float64)
    B, H, W = disp.shape
    if rgb.shape != (B, H, W, 3) or poses.shape != (B, 3):
        raise ValueError(f"shape mismatch: disp {disp.shape}, rgb "
                         f"{rgb.shape}, poses {poses.shape}")
    cam16 = np.array([
        cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy, cam_cfg.pitch_deg,
        cam_cfg.p_rc[0], cam_cfg.p_rc[1], cam_cfg.p_rc[2],
        cam_cfg.disp_a, cam_cfg.disp_b, cam_cfg.depth_scale,
        cam_cfg.reg_scale, cam_cfg.reg_i_off, cam_cfg.reg_dd,
        cam_cfg.reg_j_off, cam_cfg.reg_div], dtype=np.float64)
    cap = B * H * W
    cells = np.empty(cap, dtype=np.int32)
    colors = np.empty(cap, dtype=np.int32)
    counts = np.empty(B, dtype=np.int32)
    total = lib.slamio_project_frames(
        disp.ctypes.data_as(P), rgb.ctypes.data_as(P),
        poses.ctypes.data_as(P), B, H, W, cam16.ctypes.data_as(P),
        map_cfg.world_min_x, map_cfg.world_min_y, map_cfg.resolution,
        map_cfg.width, map_cfg.height, cells.ctypes.data_as(P),
        colors.ctypes.data_as(P), counts.ctypes.data_as(P), cap, n_threads)
    if total < 0:
        raise RuntimeError("project_frames overflowed its output capacity")
    return cells[:total].copy(), colors[:total].copy()


def dbscan(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """Exact DBSCAN labels: points (N, D) -> (N,) int32, -1 for noise,
    clusters 0..k-1 in index-order discovery (sklearn's semantics:
    neighbours at d <= eps, the point itself counted toward
    min_samples)."""
    lib = host_library()
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 2:
        raise ValueError(f"points must be (N, D), got {points.shape}")
    n, d = points.shape
    labels = np.empty(n, dtype=np.int32)
    rc = lib.slamio_dbscan(points.ctypes.data_as(P), n, d, eps, min_samples,
                           labels.ctypes.data_as(P))
    if rc < 0:
        raise ValueError(f"native dbscan rejected arguments (rc={rc})")
    return labels
