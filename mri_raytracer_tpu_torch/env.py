"""Environment report and device resolution for the port.

``python -m mri_raytracer_tpu_torch.env`` prints one JSON object: torch and
CUDA versions, the card's name, compute capability and power limit (from
``nvidia-smi``), and whether ``nvcc`` is on hand to build the kernels.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Optional, Sequence, Union

import torch

CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and no
    card is present — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def device_floats(values: Sequence[float],
                  device: Union[str, torch.device]) -> torch.Tensor:
    """A float32 tensor of ``values`` on ``device``, made by fills queued
    like any kernel: ``torch.tensor(values, device=...)`` copies from
    pageable host memory, and that blocking copy waits for the device's
    queue to drain, a host sync in the middle of a step."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def nvcc_path() -> Optional[str]:
    """Path of ``nvcc`` (PATH first, then ``$CUDA_HOME/bin``), or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` line of the first card,
    or None where ``nvidia-smi`` is missing or fails."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None


def report() -> dict:
    rep = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count(),
        "nvcc": nvcc_path(),
        "nvidia_smi": power_limit(),
    }
    if torch.cuda.is_available():
        rep["device_name"] = torch.cuda.get_device_name(0)
        rep["capability"] = list(torch.cuda.get_device_capability(0))
    return rep


if __name__ == "__main__":
    print(json.dumps(report()))
