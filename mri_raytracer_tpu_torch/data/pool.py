"""Device-resident case pool (port of ``data/pool.py``).

A stacked ``(P, M, H, W, D)`` float32 modality pool and a ``(P, H, W, D)``
int32 label pool (plus the boundary-weight pool when asked for) on the
run's device, refreshed from the host cache every ``pool_refresh`` steps;
all sampling and gathering then happens on the device
(``data/sampling.py``). The cases are picked by numpy's
``default_rng(seed).choice``, as in the JAX package, so both pools hold the
same cases. A refresh stages the cases in pinned host memory and copies
them to the device with ``non_blocking=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import resolve_device


class DevicePool:
    def __init__(self, cache, pool_size: int, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device=None,
                 with_boundary: bool = False):
        self.cache = cache
        self.pool_size = min(int(pool_size), cache.n_cases)
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self._dtype = dtype
        self._with_boundary = with_boundary
        self.mods: Optional[torch.Tensor] = None
        self.segs: Optional[torch.Tensor] = None
        self.boundary: Optional[torch.Tensor] = None
        self.refresh()

    def _put(self, arrays, dtype: torch.dtype) -> torch.Tensor:
        """Stack ``arrays`` into (pinned, on a card) host memory and copy
        them to the pool's device. PyTorch's pinned-memory allocator holds
        the staging block until its copy has run."""
        pinned = self.device.type == "cuda"
        host = torch.empty((len(arrays),) + tuple(arrays[0].shape),
                           dtype=dtype, pin_memory=pinned)
        view = host.numpy()
        for i, a in enumerate(arrays):
            view[i] = a
        return host.to(self.device, non_blocking=pinned)

    def refresh(self) -> None:
        idxs = self._rng.choice(self.cache.n_cases, size=self.pool_size,
                                replace=False)
        cases = [self.cache.get(int(i)) for i in idxs]
        self.mods = self._put([c["mods"] for c in cases], self._dtype)
        self.segs = self._put([c["seg"] for c in cases], torch.int32)
        if self._with_boundary:
            shape = cases[0]["seg"].shape
            self.boundary = self._put(
                [c.get("boundary", np.ones(shape, np.float32))
                 for c in cases], self._dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.mods.shape)

    def maybe_refresh(self, step: int, every: int) -> None:
        if every > 0 and step > 0 and step % every == 0:
            self.refresh()
