"""Inverse rendering CLI (port of ``scripts/fit_from_views.py``): fit an INR
from rendered 2-D multi-modal views only, and report recovered-view PSNR
and wall time, with the card's name and power limit beside the times.

    python -m mri_raytracer_tpu_torch.apps.fit_from_views      # marcher
    python -m mri_raytracer_tpu_torch.apps.fit_from_views \\
        --renderer shearwarp --steps 400

Protocol (reference ``docs/DifferentiableRendering.md:133-148``,
``docs/Goals.md:257``): >= 16 train views at 256^2 of a 64^3 multi-modal
volume; success = >= 30 dB mean recovered-view PSNR on the train views.
Writes ``fit_from_views[_shearwarp].json``, ``FIT_FROM_VIEWS[_shearwarp].md``
and a target / recovered PNG pair under ``--out`` (default
``build/fit_from_views/`` of the checkout). Runs on the card unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "fit_from_views"
PASS_DB = 30.0


def _write_pair(path: pathlib.Path, target: np.ndarray,
                recovered: np.ndarray) -> None:
    from mri_raytracer_tpu_torch.io.png import encode_png

    pair = np.concatenate([target[..., :3], recovered[..., :3]], axis=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png((np.clip(pair, 0, 1) * 255).astype(np.uint8)))


def _table(rec, ok: bool, timing: str) -> list:
    rows = [
        "| metric | value |",
        "|---|---|",
        f"| recovered-view PSNR (train, mean/min) | "
        f"{rec['psnr_train_mean']:.2f} / {rec['psnr_train_min']:.2f} dB |",
        f"| recovered-view PSNR (HELD-OUT, mean/min) | "
        f"{rec['psnr_heldout_mean']:.2f} / {rec['psnr_heldout_min']:.2f} dB |",
    ]
    if "volume_psnr_db" in rec:
        rows.append(f"| recovered VOLUME PSNR vs ground truth | "
                    f"{rec['volume_psnr_db']:.2f} dB |")
    rows += [
        f"| wall time: render targets | {rec['wall_s_targets']} s |",
        f"| wall time: fit | {rec['wall_s_fit']} s |",
        f"| wall time: recovered renders | {rec['wall_s_render']} s |",
        "",
        f"Times measured on {timing}.",
        "",
        f"Success bar (>= {PASS_DB:.0f} dB recovered-view PSNR): "
        f"{'MET' if ok else 'NOT MET'}.",
    ]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="64,64,64")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--held-views", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--batch-rays", type=int, default=4096)
    ap.add_argument("--n-coarse", type=int, default=48)
    ap.add_argument("--n-fine", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--out", default=None,
                    help=f"output directory (default {DEFAULT_OUT})")
    ap.add_argument("--renderer", default="marcher",
                    choices=["marcher", "shearwarp"],
                    help="'marcher': ray batches through ops/diffrender + "
                    "importance sampling. 'shearwarp': full frames through "
                    "the PRODUCTION fast renderer (composite='scan_remat') "
                    "— bake the INR to the grid differentiably, render, "
                    "backprop through bake + shear + warp")
    ap.add_argument("--out-res", type=int, default=128,
                    help="shearwarp mode: rendered output resolution")
    ap.add_argument("--views-per-step", type=int, default=2,
                    help="shearwarp mode: full frames per train step")
    args = ap.parse_args(argv)

    import torch

    from mri_raytracer_tpu_torch.env import power_limit, resolve_device
    from mri_raytracer_tpu_torch.train import fit_views

    dev = resolve_device("cpu" if args.cpu else None)
    card = (f"{torch.cuda.get_device_name(dev)} ({power_limit()})"
            if dev.type == "cuda" else "the CPU")
    shape = tuple(int(x) for x in args.shape.split(","))
    print(f"[fit] device={dev} shape={shape} res={args.res} "
          f"views={args.views} steps={args.steps}")
    if args.renderer == "shearwarp":
        rec = fit_views.run_shearwarp(
            shape=shape, res=args.res, out_res=args.out_res,
            n_train_views=args.views, n_held_views=args.held_views,
            steps=args.steps, views_per_step=args.views_per_step,
            seed=args.seed, device=dev)
    else:
        rec = fit_views.run(shape=shape, res=args.res,
                            n_train_views=args.views,
                            n_held_views=args.held_views, steps=args.steps,
                            batch_rays=args.batch_rays,
                            n_coarse=args.n_coarse, n_fine=args.n_fine,
                            seed=args.seed, device=dev)

    out_dir = pathlib.Path(args.out) if args.out else DEFAULT_OUT
    out_dir.mkdir(parents=True, exist_ok=True)
    imgs = {k: rec.pop(k) for k in list(rec) if k.startswith("_")}
    rec["device"] = card
    suffix = "_shearwarp" if args.renderer == "shearwarp" else ""
    (out_dir / f"fit_from_views{suffix}.json").write_text(
        json.dumps(rec, indent=1))
    ok = rec["psnr_train_mean"] >= PASS_DB
    verdict = "PASS" if ok else "FAIL"
    if args.renderer == "shearwarp":
        md = [
            "# Inverse rendering THROUGH the production shear-warp "
            f"renderer ({verdict})",
            "",
            f"Fit an RFF+MLP intensity field ({rec['n_params']} params, 4 "
            f"modality outputs) from {rec['n_train_views']} views rendered "
            f"at {args.res}^2 (out_res {rec['out_res']}) by "
            "`ops/shearwarp.render_brats` of a "
            f"{'x'.join(map(str, shape))} synthetic volume. Each of the "
            f"{rec['steps']} Adam steps differentiably BAKES the INR to the "
            "full voxel grid (chunks under torch.utils.checkpoint) and "
            "backprops full-frame MSE through bake + shear-resample + "
            "scan compositor + gather warp (`composite='scan_remat'`).",
            "",
        ] + _table(rec, ok, card) + [
            "",
            "Run: `python -m mri_raytracer_tpu_torch.apps.fit_from_views "
            "--renderer shearwarp`.",
        ]
    else:
        md = [
            f"# Inverse rendering from views — INR fit ({verdict})",
            "",
            f"Fit an RFF+MLP radiance field ({rec['n_params']} params) from "
            f"{rec['n_train_views']} rendered {rec['res']}x{rec['res']} "
            "multi-modal views (color channels = t1n/t1c/t2w emissions) of "
            f"a {'x'.join(map(str, shape))} synthetic volume, via "
            "`ops/diffrender` (manual O(N) compositing adjoint) + "
            "`ops/importance` inverse-CDF coarse-to-fine sampling "
            f"({rec['n_coarse']}->{rec['n_fine']} samples/ray), "
            f"{rec['steps']} Adam steps x {rec['batch_rays']} rays.",
            "",
        ] + _table(rec, ok, card) + [
            "",
            "Run: `python -m mri_raytracer_tpu_torch.apps.fit_from_views` "
            "(synthetic data).",
        ]
    name = "FIT_FROM_VIEWS_shearwarp.md" if suffix else "FIT_FROM_VIEWS.md"
    (out_dir / name).write_text("\n".join(md) + "\n")
    _write_pair(out_dir / "img" / f"fit_from_views{suffix}_pair.png",
                imgs["_targets"][0], imgs["_recovered"][0])
    print(f"[fit] train PSNR {rec['psnr_train_mean']:.2f} dB "
          f"(min {rec['psnr_train_min']:.2f}), held-out "
          f"{rec['psnr_heldout_mean']:.2f} dB; fit {rec['wall_s_fit']} s on "
          f"{card} -> {verdict}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
