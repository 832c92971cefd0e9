#!/usr/bin/env python3
"""Count the eager PyTorch calls one step of each fit from views issues.

    python3 tools/fit_step_ops.py [--device cpu|cuda] [--out-res 32]

A step of ``train/fit_views.py``'s shear-warp fit (64^3 bake, 2 views
through ``composite='scan_remat'``: 65 planes a view, forward, recomputed
and backward) and of its marcher fit (a batch of rays through the
coarse-to-fine render), each run once untimed and once under
``torch.profiler``; prints the top-level ``aten`` calls of the step (the
host's dispatch count: views included), those that are not views, and
the most frequent by name. The fits' depths are the documented ones; the
frames and ray batches are narrower by default (``--res``, ``--out-res``,
``--rays``), which leaves the call counts as they are: they follow the
planes, views, chunks and layers, not the widths. On the CPU by default
(the call count is the host's work, not a device time); imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from collections import Counter

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from mri_raytracer_tpu_torch.render import params as rp  # noqa: E402
from mri_raytracer_tpu_torch.train import fit_views as fv  # noqa: E402

SHAPE = (64, 64, 64)
# Calls that return a view of their input and launch nothing.
VIEWS = {"aten::select", "aten::unsqueeze", "aten::slice", "aten::reshape",
         "aten::t", "aten::numpy_T", "aten::squeeze", "aten::view",
         "aten::expand", "aten::transpose", "aten::alias",
         "aten::as_strided", "aten::detach", "aten::narrow",
         "aten::permute", "aten::lift_fresh"}


def captured_step(name: str, run) -> tuple:
    """(step, args) of the first step a fit's step builder makes."""
    builder = {"shear-warp": "build_shearwarp_step",
               "marcher": "build_fit_step"}[name]
    orig = getattr(fv, builder)
    got = {}

    def build(*a, **kw):
        step = orig(*a, **kw)

        def keep(*args):
            got["step"] = (step, args)
            return step(*args)

        return keep

    setattr(fv, builder, build)
    try:
        run()
    finally:
        setattr(fv, builder, orig)
    return got["step"]


def count(step, args) -> Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*args)
    return Counter(e.name for e in prof.events() if e.name.startswith(
        "aten::") and (e.cpu_parent is None
                       or not e.cpu_parent.name.startswith("aten::")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--out-res", type=int, default=32)
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    p = rp.default_render_params(SHAPE, show_seg=False)
    bases = fv.make_orbit_bases(2, radius=rp.default_camera_radius(p, SHAPE))
    quiet = lambda msg: None
    runs = {
        "shear-warp": lambda: fv.fit_views_shearwarp(
            np.zeros((2, args.res, args.res, 3), np.float32), bases, p,
            SHAPE, out_res=args.out_res, steps=1, log_fn=quiet, device=dev),
        "marcher": lambda: fv.fit_from_views(
            np.zeros((2, args.res, args.res, 3), np.float32),
            fv.make_orbit_bases(2), fv.T0, fv.T1, steps=1,
            batch_rays=args.rays, log_fn=quiet, device=dev),
    }
    for name, run in runs.items():
        c = count(*captured_step(name, run))
        total = sum(c.values())
        launches = sum(n for k, n in c.items() if k not in VIEWS)
        print(f"{name} step on {dev}: {total} top-level aten calls, "
              f"{launches} of them not views")
        for k, n in c.most_common(args.top):
            print(f"  {n:7d}  {k}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
