"""ctypes binding of the native IO runtime (own copy of ``io/native.py``).

The library is the JAX package's C++ runtime, ``runtime/mri_io.cpp``:
GIL-free parallel case loading (gzip inflate + NIfTI parse + z-score, all
in C++ worker threads) and a BC4 decoder. The port builds it at first use
with ``g++`` and the flags of ``runtime/Makefile`` into
``build/native/libmri_io.so`` (rebuilt when the source is newer), never
into ``runtime/``. Where it cannot be built, every entry point falls back
to the pure-Python implementation (``data/nifti.py``, ``data/codecs.py``),
as the JAX package's does, and the compiler's words are printed to stderr
once and kept in ``build_info()``.

The library z-scores with double-precision sums, NumPy in float32: its
volumes differ from ``brats.zscore_nonzero``'s in the last bit of some
voxels (both packages), and equal the library's own arithmetic done in
NumPy bit for bit (``tests/test_torch_port_unet.py``).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "runtime" / "mri_io.cpp"
LIB_PATH = _ROOT / "build" / "native" / "libmri_io.so"
# runtime/Makefile's CXXFLAGS and LDFLAGS.
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-lz", "-lpthread"]


class _LoadJob(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p),
        ("src_len", ctypes.c_longlong),
        ("out", ctypes.c_void_p),
        ("out_cap", ctypes.c_longlong),
        ("dims", ctypes.c_void_p),
        ("do_zscore", ctypes.c_int),
        ("status", ctypes.c_int),
    ]


_LOCK = threading.Lock()
_STATE: Dict = {"tried": False, "lib": None, "error": None, "seconds": None,
                "built": False}


def _build() -> None:
    """Compile ``SOURCE`` into ``LIB_PATH`` (atomically: concurrent
    processes each write a temporary file and rename it)."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler: {cxx!r} is not on PATH")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), "-o", tmp,
                               *LDFLAGS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}): "
                               f"{(proc.stderr or proc.stdout).strip()}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None where it cannot
    be built or loaded (the reason is in ``build_info()``)."""
    with _LOCK:
        if _STATE["tried"]:
            return _STATE["lib"]
        _STATE["tried"] = True
        t0 = time.perf_counter()
        try:
            if (not LIB_PATH.exists()
                    or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime):
                _build()
                _STATE["built"] = True
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.mri_gunzip.restype = ctypes.c_longlong
            lib.mri_nifti_to_f32.restype = ctypes.c_longlong
            lib.mri_bc4_decode.restype = ctypes.c_int
            lib.mri_load_batch.restype = ctypes.c_int
            _STATE["lib"] = lib
        except (OSError, RuntimeError) as e:
            _STATE["error"] = str(e)
            print(f"[native] libmri_io unavailable, loading through Python: "
                  f"{e}", file=sys.stderr, flush=True)
        _STATE["seconds"] = time.perf_counter() - t0
        return _STATE["lib"]


def available() -> bool:
    """Whether the library is built and loaded (builds it at first use)."""
    return _lib() is not None


def build_info() -> Dict:
    """{'available', 'built' (compiled by this process), 'seconds' (build
    and load), 'error' (the compiler's or loader's words), 'path'}."""
    _lib()
    return {"available": _STATE["lib"] is not None, "built": _STATE["built"],
            "seconds": _STATE["seconds"], "error": _STATE["error"],
            "path": str(LIB_PATH)}


def gunzip(data: bytes, max_out: int) -> bytes:
    lib = _lib()
    if lib is None:
        import gzip

        return gzip.decompress(data)
    out = np.empty(max_out, np.uint8)
    n = lib.mri_gunzip(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                       max_out)
    if n < 0:
        raise ValueError("native gunzip failed")
    return out[:n].tobytes()


def decode_bc4(data: bytes, width: int, height: int, depth: int = 1
               ) -> np.ndarray:
    lib = _lib()
    if lib is None:
        from mri_raytracer_tpu_torch.data.codecs import decode_bc4 as py

        return py(data, width, height, depth)
    bw, bh = (width + 3) // 4, (height + 3) // 4
    out = np.zeros((depth, bh * 4, bw * 4), np.uint8)
    rc = lib.mri_bc4_decode(data, len(data),
                            out.ctypes.data_as(ctypes.c_void_p),
                            bw * 4, bh * 4, depth)
    if rc != 0:
        raise ValueError("native BC4 decode failed")
    return out[:, :height, :width]


def load_nifti_batch(paths: Sequence[pathlib.Path], zscore: bool = True,
                     max_voxels: int = 256 ** 3, n_threads: int = 4,
                     ) -> List[Optional[Tuple[np.ndarray, Tuple[int, ...]]]]:
    """Parallel NIfTI loads -> list of (float32 volume (X,Y,Z), dims) or None.

    All inflate/parse/normalize work runs in C++ threads (no GIL); Python
    only reads the compressed bytes and reshapes the outputs.
    """
    lib = _lib()
    if lib is None:
        from mri_raytracer_tpu_torch.data import nifti
        from mri_raytracer_tpu_torch.data.brats import zscore_nonzero

        res = []
        for p in paths:
            arr = nifti.load(p).data.astype(np.float32)
            if zscore:
                arr = zscore_nonzero(arr)
            res.append((arr, arr.shape))
        return res

    # Bounded-chunk processing: the max_voxels staging buffers (~108 MB each
    # at the cache's 300^3 setting) and the compressed raws are reused /
    # released per chunk, so peak RSS is ~2*n_threads buffers + the final
    # right-sized volumes instead of one buffer per file in the batch.
    n = len(paths)
    chunk = max(2 * n_threads, 1)
    n_buf = min(chunk, n)
    outs = [np.empty(max_voxels, np.float32) for _ in range(n_buf)]
    dims = [np.zeros(3, np.int32) for _ in range(n_buf)]
    scratch_per = max_voxels * 8 + 4096
    scratch = np.empty(n_threads * scratch_per, np.uint8)
    results: List[Optional[Tuple[np.ndarray, Tuple[int, ...]]]] = []
    for c0 in range(0, n, chunk):
        sub = paths[c0:c0 + chunk]
        m = len(sub)
        jobs = (_LoadJob * m)()
        keep = []  # keep byte buffers alive for this chunk
        for i, p in enumerate(sub):
            raw = pathlib.Path(p).read_bytes()
            buf = ctypes.create_string_buffer(raw, len(raw))
            keep.append(buf)
            jobs[i].src = ctypes.cast(buf, ctypes.c_void_p)
            jobs[i].src_len = len(raw)
            jobs[i].out = outs[i].ctypes.data_as(ctypes.c_void_p)
            jobs[i].out_cap = max_voxels
            jobs[i].dims = dims[i].ctypes.data_as(ctypes.c_void_p)
            jobs[i].do_zscore = 1 if zscore else 0
            jobs[i].status = 1
        lib.mri_load_batch(jobs, m, n_threads,
                           scratch.ctypes.data_as(ctypes.c_void_p),
                           scratch_per)
        for i in range(m):
            if jobs[i].status != 0:
                results.append(None)
                continue
            d = tuple(int(x) for x in dims[i])
            count = int(np.prod(d))
            vol = outs[i][:count].reshape(d, order="F").copy()
            results.append((vol, d))
    return results
