"""RGB8 PNG encoder from ``zlib`` and ``struct`` alone.

The viewer CLI and the HTTP frame server write frames as PNG; the JAX apps
use PIL for it, which the port does not depend on. One code path: the
signature, an IHDR chunk (8-bit RGB, no interlace), one IDAT chunk holding
the zlib stream of every row behind filter byte 0 (None), and IEND.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} "
                         f"{rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray) -> None:
    pathlib.Path(path).write_bytes(encode_png(rgb))


def to_rgb8(img: np.ndarray) -> np.ndarray:
    """A float frame in [0, 1] -> uint8 as the JAX apps store it:
    clipped, times 255, truncated."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
