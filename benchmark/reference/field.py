"""The live INR's field of the reference frame (mode 2).

The field points are those of ``ops/neural_march.predict_field``: on every
sweep plane, the intermediate image at stride S. At each, the z-scored
modalities are resampled by the same separable two-tap hat products
(frozen copy, bf16 operands), the point's normalized global coordinates
and their harmonics ``[t | sin(k pi t) | cos(k pi t)]`` (``models/features``)
are formed, and the MLP (``models/mlp``: ReLU layers, a linear head) runs
on the concatenated input with its first layer whole, not split by axis as
the port's separable path does. The label is the argmax of the logits.

At ``STATED`` precision the operands the port rounds to bf16 (the
resample, the intensities and the first layer's intensity rows, every
later layer) are rounded to bf16 here, the coordinate part is float32,
and products sum in float32. ``Precision.resample`` at fp8 takes the
resample of the field's inputs one step down, as it does stage 1's;
``Precision.mlp`` at fp8 the MLP's operands, and bf16 its coordinate
part.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from benchmark.reference import geometry as g
from benchmark.reference.frame import Precision, rounded

_F32 = torch.float32
_BF16 = torch.bfloat16
# Sweep axis -> for each of (x, y, z), its position among (k, a, b).
INV_ORDER = {0: (0, 1, 2), 1: (1, 0, 2), 2: (1, 2, 0)}
BLOCK = 16


def fourier(t: torch.Tensor, k: int) -> torch.Tensor:
    """(N, 3) coordinates -> (N, 3 * 2k): per axis [sin k=1..K | cos]."""
    freqs = torch.arange(1, k + 1, dtype=t.dtype, device=t.device)
    ang = t[..., None] * freqs[None, None, :] * math.pi
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) \
        .reshape(t.shape[0], 3 * 2 * k)


def mlp_labels(layers: Sequence, coords: torch.Tensor, intens: torch.Tensor,
               fourier_freqs: int, prec: Precision) -> torch.Tensor:
    """argmax of the MLP over ``[coords | harmonics | intensities]``.
    ``layers``: [(W (in, out), b (out,)), ...] float32."""
    lo = prec.mlp
    coord_t = _F32 if lo == _BF16 else _BF16
    x_c = torch.cat([coords, fourier(coords, fourier_freqs)], dim=-1)
    W1, b1 = layers[0]
    nc = x_c.shape[1]
    h = rounded(x_c, coord_t) @ rounded(W1[:nc], coord_t) + b1
    h += rounded(intens, lo) @ rounded(W1[nc:], lo)
    h = torch.relu_(h).to(_BF16).to(_F32)
    for W, b in layers[1:-1]:
        h = torch.relu_(rounded(h, lo) @ rounded(W, lo) + b)
    W, b = layers[-1]
    return torch.argmax(rounded(h, lo) @ rounded(W, lo) + b, dim=-1)


def field(layers, fourier_freqs: int, modsz_s: torch.Tensor, geom: g.Geom,
          p: g.Params, fr: g.Frame, stride: int,
          prec: Precision) -> torch.Tensor:
    """(K + 1, O / S, O / S) uint8 labels in sweep order, labels outside
    [1, 8) as 0 (transparent): the field every plane of the frame
    overlays. ``modsz_s``: (M, K, Na, Nb) cropped z-scored modalities."""
    M, Nk, Na, Nb = modsz_s.shape
    out_res = fr.out_res
    Op = out_res // stride
    dev = modsz_s.device
    n_planes = Nk + 1
    z, z_glob, _, off_a, sc_a, off_b, sc_b = g.plane_affines(
        geom, p, fr.axis, n_planes, float(fr.crops[0][0]))
    zi = torch.clamp(z, 0.0, Nk - 1).long()
    acl, ach, _, aml, amh = g.crop_bounds(geom, 0, Na)
    bcl, bch, _, bml, bmh = g.crop_bounds(geom, 1, Nb)
    inv = INV_ORDER[fr.axis]
    dims_g = [float(d) for d in fr.dims_perm]

    def norm(t, d):
        return (t / (d - 1.0)) * 2.0 - 1.0

    iis = torch.arange(Op, dtype=_F32, device=dev) * stride
    out = []
    for m0 in range(0, n_planes, BLOCK):
        sl_m = slice(m0, min(m0 + BLOCK, n_planes))
        oa, sa, ob, sb = off_a[sl_m], sc_a[sl_m], off_b[sl_m], sc_b[sl_m]
        B = oa.shape[0]
        Wa, _ = g.hat_weights(oa, sa * stride, Na, Op, acl, ach, aml, amh)
        Wb, _ = g.hat_weights(ob, sb * stride, Nb, Op, bcl, bch, bml, bmh)
        sl = modsz_s.index_select(1, zi[sl_m])  # (M, B, Na, Nb)
        rd = prec.resample
        t1 = rounded(Wa, rd)[None] @ rounded(sl, rd)
        v = rounded(t1, rd) @ rounded(Wb, rd).transpose(1, 2)[None]
        intens = v.permute(1, 2, 3, 0).reshape(-1, M)

        ka = norm(z_glob[sl_m], dims_g[0])[:, None, None].expand(B, Op, Op)
        pa = norm(oa[:, None] + iis[None, :] * sa[:, None] + geom.a_off,
                  dims_g[1])[:, :, None].expand(B, Op, Op)
        pb = norm(ob[:, None] + iis[None, :] * sb[:, None] + geom.b_off,
                  dims_g[2])[:, None, :].expand(B, Op, Op)
        kab = (ka, pa, pb)
        xyz = torch.stack([kab[inv[c]] for c in range(3)], dim=-1)
        lab = mlp_labels(layers, xyz.reshape(-1, 3), intens, fourier_freqs,
                         prec)
        out.append(lab.reshape(B, Op, Op))
    lab = torch.cat(out)
    return torch.where((lab > 0) & (lab < 8), lab, 0).to(torch.uint8)
