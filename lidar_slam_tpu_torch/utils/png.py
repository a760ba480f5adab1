"""Minimal PNG IO with numpy and zlib.

Counterpart of lidar_slam_tpu/utils/png.py: write_png emits the same bytes
for the same image (8-bit gray or RGB, 16-bit gray; filter type 0 on every
scanline; zlib level 6). read_png decodes with the port's native libpng
decoder (utils/native.py) where it builds, else in Python (read_png_python:
8-bit gray/RGB/RGBA and 16-bit gray, every scanline filter); both give the
same array.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) gray (uint8/uint16) or (H, W, 3) RGB uint8 as PNG."""
    image = np.asarray(image)
    depth = 8
    if image.dtype == np.uint16:
        if image.ndim != 2:
            raise ValueError("16-bit write supports grayscale only")
        depth = 16
    elif image.dtype != np.uint8:
        raise ValueError(f"write_png expects uint8/uint16, got {image.dtype}")
    if image.ndim == 2:
        color_type = 0  # grayscale
        h, w = image.shape
        raw = image[:, :, None]
    elif image.ndim == 3 and image.shape[2] == 3:
        color_type = 2  # RGB
        h, w, _ = image.shape
        raw = image
    else:
        raise ValueError(
            f"write_png expects (H,W) or (H,W,3), got {image.shape}")
    if depth == 16:
        raw = raw.astype(">u2")  # PNG 16-bit samples are big-endian
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scanlines, 6))
            + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _paeth(a, b, c):
    p = int(a) + int(b) - int(c)
    pa, pb, pc = abs(p - int(a)), abs(p - int(b)), abs(p - int(c))
    if pa <= pb and pa <= pc:
        return int(a)
    return int(b) if pb <= pc else int(c)


def read_png(path: str) -> np.ndarray:
    """Read a PNG into a numpy array: (H, W) for gray, (H, W, C) otherwise;
    uint8, or uint16 for 16-bit samples. The native decoder where libpng
    built, else read_png_python (JAX utils/png.py:79-80)."""
    from . import native

    if native.png_available():
        return native.read_png(path)
    return read_png_python(path)


def read_png_python(path: str) -> np.ndarray:
    """The pure-Python decoder of a non-interlaced PNG (8-bit gray, RGB,
    RGBA and 16-bit gray; every scanline filter)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = []
    w = h = depth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if depth not in (8, 16):
        raise ValueError(f"bit depth {depth} unsupported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    fb = channels * depth // 8  # filter unit in bytes
    stride = w * fb
    arr = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    img = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = arr[y * (stride + 1)]
        line = arr[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 2:  # Up
            cur = line + prev  # uint8 arithmetic wraps mod 256
        elif ftype in (1, 3, 4):  # Sub, Average, Paeth: left to right
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - fb]) if x >= fb else 0
                b = int(prev[x])
                c = int(prev[x - fb]) if x >= fb else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, c)
                cur[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        img[y] = cur
        prev = cur
    if depth == 8:
        out = img.reshape(h, w, channels)
    else:
        pairs = img.reshape(h, w, channels, 2).astype(np.uint16)
        out = (pairs[..., 0] << 8) | pairs[..., 1]
    return out.squeeze()
