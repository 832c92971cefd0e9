"""The case a cell renders, made on the device from ``--seed``.

``case_from_draws`` is a frozen copy of ``data/synthetic.synthetic_case``
(the port's copy of the JAX package's generator) in torch: the same
ellipsoid brain with its low-frequency texture, the same three concentric
tumour shells and the same per-modality contrasts and noise. ``make_case``
draws its random numbers with a ``torch.Generator`` on the device, in a few
large calls, so a case is not bit-equal to numpy's at the same seed; the
tests feed ``case_from_draws`` numpy's draws and hold it against the
original.

Then the viewer's two normalizations (``data/brats``): percentile [1, 99.5]
-> [0, 1] for display, and the z-score over the nonzero mask that the INR
was trained on.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

_F32 = torch.float32
N_WAVES = 6
# Tumour contrast per (label, modality) (``synthetic_case``).
CONTRAST = ((0, 0, 0, 0), (-200, 150, -100, 250), (100, -150, 350, 220),
            (300, 400, -50, 150))


def coords(shape: Sequence[int], device) -> torch.Tensor:
    """Normalized [-1, 1] coordinate grid, (H, W, D, 3)."""
    axes = [torch.linspace(-1.0, 1.0, int(s), dtype=_F32, device=device)
            for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def case_from_draws(shape: Sequence[int], k: torch.Tensor, ph: torch.Tensor,
                    center: torch.Tensor, noise: torch.Tensor):
    """(M, H, W, D) raw float32 modalities and (H, W, D) int32 labels 0..3
    from the generator's draws: ``k`` (6, 3) wave vectors ~ N(0, 2),
    ``ph`` (6,) phases ~ U(0, 2 pi), ``center`` (3,) ~ U(-0.25, 0.25),
    ``noise`` (M, H, W, D) ~ N(0, 8)."""
    dev = noise.device
    g = coords(shape, dev)
    ell = (g[..., 0] / 0.85) ** 2 + (g[..., 1] / 0.8) ** 2 \
        + (g[..., 2] / 0.75) ** 2
    brain = (ell < 1.0).to(_F32)
    tex = torch.zeros(tuple(shape), dtype=_F32, device=dev)
    for w in range(N_WAVES):
        tex += torch.cos((g @ k[w].to(_F32)) * math.pi + ph[w])
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-6)

    d2 = ((g - center.to(_F32)) ** 2).sum(-1)
    seg = torch.zeros(tuple(shape), dtype=torch.int32, device=dev)
    seg[d2 < 0.45 ** 2] = 2  # edema (outer)
    seg[d2 < 0.32 ** 2] = 3  # enhancing
    seg[d2 < 0.20 ** 2] = 1  # necrotic core
    seg[brain == 0] = 0

    mods = []
    for m in range(noise.shape[0]):
        vol = brain * (400.0 + 600.0 * tex) * (0.7 + 0.3 * math.cos(m * 1.3))
        for c in range(1, 4):
            vol = vol + (seg == c).to(_F32) * float(CONTRAST[c % 4][m % 4])
        vol = vol + noise[m] * brain
        mods.append(torch.clamp(vol, min=0.0))
    return torch.stack(mods), seg


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``np.percentile(x, q)`` with linear interpolation, for any size."""
    v = torch.sort(x.reshape(-1)).values
    pos = q / 100.0 * (v.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    return v[lo] + (pos - lo) * (v[hi] - v[lo])


def percentile_normalize(x: torch.Tensor, lo: float = 1.0,
                         hi: float = 99.5) -> torch.Tensor:
    a, b = percentile(x, lo), percentile(x, hi)
    b = torch.where(b <= a, a + 1e-6, b)
    return torch.clamp((x - a) / (b - a), 0.0, 1.0)


def zscore_nonzero(x: torch.Tensor) -> torch.Tensor:
    mask = x != 0
    if not bool(mask.any()):
        return x
    sel = x[mask]
    return (x - sel.mean()) / (sel.std(correction=0) + 1e-6)


def make_case(shape: Sequence[int], seed: int, device,
              num_modalities: int = 4) -> Dict[str, torch.Tensor]:
    """The cell's inputs on ``device``: ``mods_disp`` (M, H, W, D) display
    intensities in [0, 1], ``mods_z`` (M, H, W, D) z-scored intensities,
    ``seg`` (H, W, D) int32 labels."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    shape = tuple(int(s) for s in shape)
    k = torch.randn((N_WAVES, 3), generator=gen, device=device) * 2.0
    ph = torch.rand((N_WAVES,), generator=gen, device=device) * (2 * math.pi)
    center = torch.rand((3,), generator=gen, device=device) * 0.5 - 0.25
    noise = torch.randn((num_modalities,) + shape, generator=gen,
                        device=device) * 8.0
    raw, seg = case_from_draws(shape, k, ph, center, noise)
    del noise
    disp = torch.stack([percentile_normalize(m) for m in raw])
    z = torch.stack([zscore_nonzero(m) for m in raw])
    return {"mods_disp": disp.contiguous(), "mods_z": z.contiguous(),
            "seg": seg}
