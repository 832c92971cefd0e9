"""Arithmetic ceiling of per-ray sample redistribution, per ROI scene
(port of ``scripts/roi_occupancy_bound.py``).

At equal in-content quality a redistribution policy cannot sample the
live (occupied AND unoccluded) parts of a ray's chord coarser than the
fixed-step baseline does, so its budget floor is ``live_chord_fraction x
B1`` a ray, and the speedup ceiling ``1 / live_chord_fraction`` before
coarse-pass overhead and decision-block granularity. Tumour scenes measure
~0.52 (the whole head emits), which caps redistribution below the
showcase plan's 1.8x bar: the reason for the foveated screen-space mode
(``ops/roi_policy.render_policy_foveated``). The bound is geometry, not
wall-clock.

    python -m mri_raytracer_tpu_torch.apps.roi_occupancy_bound

Runs on the card unless ``--device cpu`` (the JAX script always runs on
its CPU); no kernel of the port.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="ROI redistribution ceiling "
                                 "per scene")
    ap.add_argument("--shape", default="96,96,80")
    ap.add_argument("--suite", default="showcase",
                    choices=["showcase", "adversarial"])
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--rect-frac", type=float, default=0.5,
                    help="foveated inset fraction per screen axis "
                    "(ops/roi_policy.render_policy_foveated default)")
    ap.add_argument("--device", default="cuda")
    return ap


def live_chord_fraction(sc, width: int, height: int, frames: int,
                        n: int = 64) -> float:
    """Mean over the orbit's ``frames`` poses of the live fraction of the
    valid rays' chords (occupancy > 0.02 and entry transmittance > 1e-3
    at ``n`` uniform samples)."""
    import torch

    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy
    from mri_raytracer_tpu_torch.ops.trilinear import nearest_sample_rows
    from mri_raytracer_tpu_torch.render.camera import unpack_basis

    p = sc["params"]
    mixed = sc["mixed"]
    dev = mixed.device
    fracs = []
    for bv in roi_protocol.make_orbit_views(sc["radius"], frames):
        basis = unpack_basis(torch.as_tensor(bv, device=dev))
        dims = torch.tensor(mixed.shape, dtype=torch.float32, device=dev)
        ro, rd, t0, t1, valid, bmin = roi_policy._ray_setup(
            basis, p, dims, width, height)
        kk = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
        t = t0[..., None] + kk * (t1 - t0)[..., None]
        pos = ro[..., None, :] + t[..., None] * rd[..., None, :]
        pidx = (pos - bmin) / p.voxel_size
        occ = nearest_sample_rows(sc["feat_rows"], pidx)[..., 7]
        val = roi_policy.transfer_function(
            roi_policy._sample_any(mixed, pidx), p.ww, p.wl, p.gamma)
        dt = ((t1 - t0) / n)[..., None]
        a = 1 - torch.exp(-val * p.intensity_alpha * dt)
        T_in = torch.cat([torch.ones_like(a[..., :1]),
                          torch.cumprod(1 - a, dim=-1)[..., :-1]], -1)
        live = (occ > 0.02) & (T_in > 1e-3) & valid[..., None]
        frac = torch.sum(live, dim=-1) / n
        m = valid & (frac > 0)
        fracs.append(float(torch.sum(torch.where(m, frac, 0.0))
                           / torch.clamp(torch.sum(m), min=1)))
    return float(np.mean(fracs))


def bound_line(name: str, f: float, rect_frac: float) -> str:
    # Foveated screen-space ceiling ON TOP of redistribution: the ROI inset
    # at full resolution (rect_frac^2 of the rays) and the rest of the
    # frame at half resolution (1/4 of the rays), every ray still bounded
    # by the live-chord floor.
    ray_factor = 0.25 + rect_frac ** 2
    return (f"{name:10s} live-chord fraction {f:.3f} -> "
            f"redistribution ceiling ~{1.0 / f:.2f}x (ideal); "
            f"+foveation (rect_frac={rect_frac}, ray factor "
            f"{ray_factor:.2f}) -> ~{1.0 / (f * ray_factor):.2f}x")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.eval import roi_protocol

    dev = resolve_device(args.device)
    shape = tuple(int(x) for x in args.shape.split(","))
    with torch.no_grad():
        for sc in roi_protocol.build_scenes(shape, suite=args.suite,
                                            device=dev):
            f = live_chord_fraction(sc, args.width, args.height, args.frames)
            print(bound_line(sc["name"], f, args.rect_frac))
    return 0


if __name__ == "__main__":
    sys.exit(main())
