"""Minimal pure-numpy NIfTI-1 reader/writer (.nii / .nii.gz).

Own copy of ``mri_raytracer_tpu/data/nifti.py``; files written by either
load equal in the other (``tests/test_torch_port_apps.py``). The reference
uses ``nibabel`` for all volume IO (``inr/inr/dataloader.py:28``,
``inr/viewer/brats_viewer.py:46-74``); this codec needs numpy and gzip only.
It supports the subset the pipeline needs: NIfTI-1 single-file volumes, both
endiannesses, the common datatypes, scl_slope/scl_inter scaling, and
sform/qform affines (index -> world mm per
``docs/DifferentiableRendering.md:9-10``).
"""

from __future__ import annotations

import gzip
import pathlib
import struct
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_HDR_SIZE = 348


@dataclass
class NiftiImage:
    data: np.ndarray  # (X, Y, Z[, T]) array, already scl-scaled if slope != 0/1
    affine: np.ndarray  # (4, 4) index -> world (mm)
    pixdim: Tuple[float, float, float]

    @property
    def shape(self):
        return self.data.shape


def _quaternion_affine(b: float, c: float, d: float, qo: np.ndarray,
                       pixdim: np.ndarray, qfac: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    S = np.diag([pixdim[0], pixdim[1], pixdim[2] * (qfac if qfac != 0 else 1.0)])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = qo
    return aff


def _open_maybe_gz(path: pathlib.Path, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: Union[str, pathlib.Path]) -> NiftiImage:
    path = pathlib.Path(path)
    with _open_maybe_gz(path) as f:
        raw = f.read()

    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")

    # Detect endianness from sizeof_hdr.
    (size_le,) = struct.unpack_from("<i", raw, 0)
    bo = "<" if size_le == _HDR_SIZE else ">"
    (size_chk,) = struct.unpack_from(bo + "i", raw, 0)
    if size_chk != _HDR_SIZE:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={size_le})")
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(bo + "8h", raw, 40)
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(x) for x in dim[1:1 + ndim])
    (datatype,) = struct.unpack_from(bo + "h", raw, 70)
    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(bo + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(bo + "2f", raw, 112)
    qform_code, sform_code = struct.unpack_from(bo + "2h", raw, 252)
    qb, qc, qd, qx, qy, qz = struct.unpack_from(bo + "6f", raw, 256)
    srow = np.array(struct.unpack_from(bo + "12f", raw, 280)).reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    offset = int(vox_offset) if vox_offset >= _HDR_SIZE else _HDR_SIZE
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    # NIfTI stores Fortran order (x fastest).
    data = data.reshape(shape, order="F")
    if bo == ">":
        data = data.astype(data.dtype.newbyteorder("="))

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    elif qform_code > 0:
        affine = _quaternion_affine(qb, qc, qd, np.array([qx, qy, qz]),
                                    np.array(pixdim[1:4]), pixdim[0])
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    return NiftiImage(data=np.asarray(data), affine=affine,
                      pixdim=tuple(float(abs(p)) for p in pixdim[1:4]))


def save(path: Union[str, pathlib.Path], data: np.ndarray,
         affine: Optional[np.ndarray] = None) -> None:
    path = pathlib.Path(path)
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    if affine is None:
        affine = np.eye(4)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, *([1.0] * 4))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform=0, sform=1
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].reshape(-1))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)
