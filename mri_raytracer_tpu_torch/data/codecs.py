"""Volume codecs: BC4 block decompression + raw u8 (.gz) volumes (port of
``data/codecs.py``; reference H2, ``scripts/volumeRendering/app.py``: r8/bc4
formats of the t1_icbm demo volume).

Host-side NumPy, bit-equal to the JAX package's copy. The BC4 decoder is
fully vectorized (palette build + 3-bit index extraction across all blocks
at once), mirroring the reference's approach (``app.py:200-250``) with
identical unsigned-BC4 semantics.
"""

from __future__ import annotations

import gzip
import pathlib
from typing import Sequence

import numpy as np


def decode_bc4(data: bytes, width: int, height: int, depth: int = 1) -> np.ndarray:
    """Unsigned BC4 -> (depth, height, width) uint8.

    Layout: 4x4 texel blocks, 8 bytes each: r0, r1 (u8) then 16 3-bit codes
    little-endian in 6 bytes. r0 > r1 -> 8-entry interpolated palette;
    r0 <= r1 -> 6-entry palette + {0, 255}.
    """
    bw, bh = (width + 3) // 4, (height + 3) // 4
    blocks_per_slice = bw * bh
    n_blocks = blocks_per_slice * depth
    raw = np.frombuffer(data, dtype=np.uint8)
    if raw.size < n_blocks * 8:
        raise ValueError(f"BC4 data too small: {raw.size} < {n_blocks * 8}")
    blocks = raw[: n_blocks * 8].reshape(n_blocks, 8)

    r0 = blocks[:, 0].astype(np.float32)
    r1 = blocks[:, 1].astype(np.float32)

    # Build both palette variants for every block, select per block.
    k = np.arange(1, 7, dtype=np.float32)
    pal_a = np.empty((n_blocks, 8), np.float32)  # r0 > r1
    pal_a[:, 0] = r0
    pal_a[:, 1] = r1
    pal_a[:, 2:] = ((7 - k)[None, :] * r0[:, None] + k[None, :] * r1[:, None]) / 7.0
    k5 = np.arange(1, 5, dtype=np.float32)
    pal_b = np.empty((n_blocks, 8), np.float32)  # r0 <= r1
    pal_b[:, 0] = r0
    pal_b[:, 1] = r1
    pal_b[:, 2:6] = ((5 - k5)[None, :] * r0[:, None] + k5[None, :] * r1[:, None]) / 5.0
    pal_b[:, 6] = 0.0
    pal_b[:, 7] = 255.0
    pal = np.where((r0 > r1)[:, None], pal_a, pal_b)
    pal = np.clip(np.rint(pal), 0, 255).astype(np.uint8)

    # 16 x 3-bit codes from the 6 index bytes (little-endian bit stream).
    idx_bytes = blocks[:, 2:8].astype(np.uint64)
    stream = (idx_bytes[:, 0] | (idx_bytes[:, 1] << 8) | (idx_bytes[:, 2] << 16)
              | (idx_bytes[:, 3] << 24) | (idx_bytes[:, 4] << 32)
              | (idx_bytes[:, 5] << 40))
    shifts = (3 * np.arange(16, dtype=np.uint64))[None, :]
    codes = ((stream[:, None] >> shifts) & np.uint64(7)).astype(np.int64)
    texels = np.take_along_axis(pal, codes, axis=1)  # (n_blocks, 16) u8

    # Scatter 4x4 blocks into the image.
    out = np.zeros((depth, bh * 4, bw * 4), np.uint8)
    texels = texels.reshape(depth, bh, bw, 4, 4)
    out = texels.transpose(0, 1, 3, 2, 4).reshape(depth, bh * 4, bw * 4)
    return out[:, :height, :width]


def encode_bc4(img: np.ndarray) -> bytes:
    """Simple unsigned BC4 encoder (testing aid): per 4x4 block, r0 = max,
    r1 = min (interpolated mode), nearest palette index per texel."""
    if img.ndim == 2:
        img = img[None]
    depth, height, width = img.shape
    ph, pw = (-height) % 4, (-width) % 4
    img = np.pad(img, ((0, 0), (0, ph), (0, pw)), mode="edge")
    bh, bw = img.shape[1] // 4, img.shape[2] // 4
    blocks = img.reshape(depth, bh, 4, bw, 4).transpose(0, 1, 3, 2, 4)
    blocks = blocks.reshape(-1, 16).astype(np.float32)
    r0 = blocks.max(1)
    r1 = blocks.min(1)
    same = r0 <= r1
    r0 = np.where(same, np.minimum(r0 + 1, 255), r0)  # force r0 > r1 mode
    k = np.arange(1, 7, dtype=np.float32)
    pal = np.empty((blocks.shape[0], 8), np.float32)
    pal[:, 0] = r0
    pal[:, 1] = r1
    pal[:, 2:] = ((7 - k)[None] * r0[:, None] + k[None] * r1[:, None]) / 7.0
    codes = np.abs(blocks[:, :, None] - pal[:, None, :]).argmin(-1).astype(np.uint64)
    stream = np.zeros(blocks.shape[0], np.uint64)
    for i in range(16):
        stream |= codes[:, i] << np.uint64(3 * i)
    out = np.zeros((blocks.shape[0], 8), np.uint8)
    out[:, 0] = r0.astype(np.uint8)
    out[:, 1] = r1.astype(np.uint8)
    for i in range(6):
        out[:, 2 + i] = ((stream >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
    return out.tobytes()


def load_u8_volume(path, dims: Sequence[int]) -> np.ndarray:
    """Raw (optionally .gz) u8 volume -> (X, Y, Z) with x fastest on disk
    (reference demo volume layout, ``app.py:60-66``)."""
    path = pathlib.Path(path)
    raw = (gzip.open(path, "rb").read() if str(path).endswith(".gz")
           else path.read_bytes())
    x, y, z = dims
    arr = np.frombuffer(raw, np.uint8, count=x * y * z)
    return arr.reshape(z, y, x).transpose(2, 1, 0)


def load_bc4_volume(path, dims: Sequence[int]) -> np.ndarray:
    """BC4-compressed (optionally .gz) volume -> (X, Y, Z) uint8."""
    path = pathlib.Path(path)
    raw = (gzip.open(path, "rb").read() if str(path).endswith(".gz")
           else path.read_bytes())
    x, y, z = dims
    dec = decode_bc4(raw, x, y, z)  # (Z, Y, X)
    return dec.transpose(2, 1, 0)
