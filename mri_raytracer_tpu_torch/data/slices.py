"""Axial-slice dataset + prefetch pipeline (port of ``data/slices.py``,
reference D7, D14).

  * ``build_slice_index`` — (case, z) manifest with background-slice
    dropping (keep slices whose tumor fraction >= ``min_fg_frac`` plus a
    quota of background slices), reference ``build_indexed_slices``
  * ``slice_batches`` — shuffled minibatch generator of (N,H,W,C) images +
    (N,H,W) labels, padded to pool-friendly sizes
  * ``prefetch`` — daemon-thread queue that stages each batch in pinned
    host memory and copies it to the device with ``non_blocking=True``
    (reference ``prefetch_generator``, ``neumors_inr_jax.ipynb §9``; the
    JAX package's ``jax.device_put`` double buffer)

The first two are the JAX package's NumPy code, so their output is its
output bit for bit (``tests/test_torch_port_unet.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import resolve_device


def build_slice_index(cache, min_fg_frac: float = 0.0,
                      bg_keep_ratio: float = 0.3, seed: int = 0
                      ) -> List[Tuple[int, int]]:
    """(case_idx, z) pairs; drops most background-only slices."""
    rng = np.random.default_rng(seed)
    index: List[Tuple[int, int]] = []
    for ci in range(cache.n_cases):
        seg = cache.get(ci)["seg"]
        for z in range(seg.shape[-1]):
            fg = float((seg[..., z] > 0).mean())
            if fg > min_fg_frac:
                index.append((ci, z))
            elif rng.uniform() < bg_keep_ratio:
                index.append((ci, z))
    return index


def _pad_to(x: np.ndarray, mult: int = 8) -> np.ndarray:
    H, W = x.shape[:2]
    ph, pw = (-H) % mult, (-W) % mult
    if ph or pw:
        pad = [(0, ph), (0, pw)] + [(0, 0)] * (x.ndim - 2)
        x = np.pad(x, pad)
    return x


def slice_batches(cache, index: Sequence[Tuple[int, int]], batch_size: int,
                  seed: int = 0, epochs: Optional[int] = 1,
                  pad_mult: int = 8) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (imgs (N,H,W,M) f32, labels (N,H,W) i32), shuffled per epoch."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(index))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            imgs, labs = [], []
            for k in order[s:s + batch_size]:
                ci, z = index[k]
                case = cache.get(ci)
                img = np.moveaxis(case["mods"][:, :, :, z], 0, -1)
                imgs.append(_pad_to(img.astype(np.float32), pad_mult))
                labs.append(_pad_to(case["seg"][:, :, z].astype(np.int32),
                                    pad_mult))
            yield np.stack(imgs), np.stack(labs)
        epoch += 1


def _to_device(item, device: torch.device):
    """A batch (a tuple of arrays) as tensors on ``device``: on a card,
    each array is copied into pinned host memory and then to the card with
    ``non_blocking=True`` (PyTorch's pinned-memory allocator holds the
    staging block until its copy has run), as ``data/pool.py`` stages."""
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(x, device) for x in item)
    pinned = device.type == "cuda"
    host = torch.empty(item.shape, dtype=torch.from_numpy(item[:0]).dtype,
                       pin_memory=pinned)
    host.numpy()[...] = item
    return host.to(device, non_blocking=pinned)


def prefetch(gen: Iterator, max_prefetch: int = 2, device=None) -> Iterator:
    """Daemon-thread prefetcher that stages batches on ``device`` (``cuda``
    unless given) ahead of use: the worker builds, pins and enqueues the
    next ``max_prefetch`` batches' copies while the consumer's step runs.
    The copies go to the same CUDA stream as the step, so a batch is on the
    device before any later kernel reads it. An exception in ``gen`` is
    raised in the consumer."""
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max_prefetch)
    _END = object()

    def worker():
        try:
            for item in gen:
                q.put((_to_device(item, dev), None))
        except BaseException as e:  # handed to the consumer
            q.put((None, e))
        finally:
            q.put((_END, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item, err = q.get()
        if err is not None:
            raise err
        if item is _END:
            return
        yield item
