"""Animated GIF89a writer from ``numpy`` alone.

The noise demo's ``--gif`` writes its frames as one looping GIF; the JAX
app uses PIL for it, which the port does not depend on. Colours map to a
fixed 256-entry palette: a 6 x 6 x 6 colour cube and a 40-step grey ramp,
each pixel to the nearer of its cube and ramp entries. The image data is
LZW in its simplest valid form: every pixel a literal 9-bit code, with a
clear code before the decoder's table would widen the codes.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Sequence

import numpy as np

_CUBE = 6
_GREYS = 40
_CLEAR, _END = 256, 257
# Literals between clear codes: after a clear the decoder adds one table
# entry per code from the second on, from 258; it widens to 10 bits at
# 512, which 250 literals never reach.
_RUN = 250


def palette() -> np.ndarray:
    """(256, 3) uint8: the colour cube, then the grey ramp."""
    lv = np.round(np.arange(_CUBE) * 255.0 / (_CUBE - 1)).astype(np.uint8)
    cube = np.stack(np.meshgrid(lv, lv, lv, indexing="ij"), -1).reshape(-1, 3)
    grey = np.round(np.arange(_GREYS) * 255.0 / (_GREYS - 1)).astype(np.uint8)
    return np.concatenate([cube, np.repeat(grey[:, None], 3, 1)])


def quantize(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices."""
    f = rgb.astype(np.float32)
    q = np.round(f * ((_CUBE - 1) / 255.0)).astype(np.int64)
    cube_idx = (q[..., 0] * _CUBE + q[..., 1]) * _CUBE + q[..., 2]
    g = np.round(f.mean(-1) * ((_GREYS - 1) / 255.0)).astype(np.int64)
    pal = palette().astype(np.float32)
    grey_idx = _CUBE ** 3 + g
    d_cube = ((f - pal[cube_idx]) ** 2).sum(-1)
    d_grey = ((f - pal[grey_idx]) ** 2).sum(-1)
    return np.where(d_grey < d_cube, grey_idx, cube_idx).astype(np.uint8)


def _lzw(indices: np.ndarray) -> bytes:
    """The image data sub-blocks of one frame: min code size 8, 9-bit
    literal codes with a clear code every ``_RUN`` pixels, then the end
    code."""
    px = indices.reshape(-1).astype(np.int64)
    n_runs = -(-px.size // _RUN)
    codes = []
    for r in range(n_runs):
        codes.append(np.array([_CLEAR], np.int64))
        codes.append(px[r * _RUN:(r + 1) * _RUN])
    codes.append(np.array([_END], np.int64))
    codes = np.concatenate(codes)
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    out = bytearray([8])
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    out += b"\x00"
    return bytes(out)


def encode_gif(frames: Sequence[np.ndarray], duration_ms: int) -> bytes:
    """(H, W, 3) uint8 frames -> a looping GIF89a, ``duration_ms`` a
    frame (rounded to the format's centiseconds)."""
    h, w, _ = frames[0].shape
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global table, 256
    out += palette().tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    delay = max(0, int(round(duration_ms / 10.0)))
    for f in frames:
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(f"expected ({h}, {w}, 3) uint8 frames, got "
                             f"{f.shape} {f.dtype}")
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += _lzw(quantize(f))
    out += b"\x3b"
    return bytes(out)


def write_gif(path, frames: Sequence[np.ndarray], duration_ms: int) -> None:
    pathlib.Path(path).write_bytes(encode_gif(frames, duration_ms))
