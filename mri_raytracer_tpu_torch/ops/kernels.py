"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``). The library's file name
carries a hash of its source, so an edited source is rebuilt and a stale
library is never loaded. ``build`` starts one ``nvcc`` per missing library,
all at once. Wrappers bind their entry point with ``function``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time
from typing import Dict, Iterable, Sequence, Tuple

import torch

from mri_raytracer_tpu_torch.env import nvcc_path
from mri_raytracer_tpu_torch.utils import profiling

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("composite", "warp", "inr_mlp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], object] = {}


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns ``{name: (seconds, nvcc
    output)}`` for the sources it compiled (``-Xptxas -v`` reports
    registers, shared memory and spills), and adds them and the call's
    seconds to the counters ``kernels.builds`` and ``kernels.build_s``.
    Raises if ``nvcc`` is missing or fails."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = so.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, so, log, time.perf_counter())
    done = {}
    try:
        for name, (proc, tmp, so, log, t0) in jobs.items():
            rc = proc.wait(timeout=900)
            out = log.read_text()
            if rc != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(exit {rc}):\n{out}")
            os.replace(tmp, so)
            done[name] = (time.perf_counter() - t0, out)
    finally:
        for proc, *_ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if done:
        profiling.count("kernels.builds", len(done))
        profiling.count("kernels.build_s", time.perf_counter() - t0)
    return done


def function(name: str, symbol: str, argtypes: Sequence):
    """The C entry ``symbol`` of ``csrc/{name}.cu``, built if needed, with
    its ``argtypes`` declared and an ``int`` (cudaError_t) result. Bound
    once per process: later calls return the same function."""
    fn = _FNS.get((name, symbol))
    if fn is not None:
        return fn
    lib = _LIBS.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build([name])
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _FNS[(name, symbol)] = fn
    return fn


def refuse_grad(what: str, *tensors) -> None:
    """A kernel has no backward: its output would cut the autograd graph
    without an error, so an input that requires grad is refused while grad
    is enabled (JAX: no VJP rule for the Pallas kernels)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: an input requires grad. Render under "
            "torch.no_grad(), or differentiate through composite="
            "'scan_remat' (the plain scan and the gather warp)")
