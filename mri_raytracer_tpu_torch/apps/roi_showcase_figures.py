"""Showcase figures of the ROI policy renderer (port of
``scripts/roi_showcase_figures.py``; reference ``docs/showcase-plan.md:
52-57``: "Reference, baseline, and ours frames exported for key views",
"Pareto plots ... generated from docs/experiments.csv").

    python -m mri_raytracer_tpu_torch.apps.roi_showcase_figures [--skip-frames]

Reads the protocol sweep (``docs/roi_results.json``) and the exported
policy (``docs/roi_policy.npz``, ``roi_policy_meta.json``) of the repo and
writes under ``--out`` (default ``build/roi_showcase_figures/``):
  img/roi_pareto_<scene>.png    speed-quality Pareto curve (drawn with
                                PIL: the card's machine has no matplotlib)
  img/roi_frames_<scene>.png    reference | B1 | policy side by side
  experiments.csv               every (scene, view set, method, budget)
The frames render on the card unless ``--device cpu`` (no kernel of the
port: the ROI renderers are PyTorch).
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
DOCS = REPO / "docs"
DEFAULT_OUT = REPO / "build" / "roi_showcase_figures"

# Validated categorical palette (dataviz reference instance, light mode).
C_BASE = "#2a78d6"   # series 1: fixed-step baseline
C_POL = "#eb6834"    # series 2: policy renderer
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK2 = "#52514e"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="ROI showcase figures "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--shape", default="96,96,80")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--ref-steps", type=int, default=448)
    ap.add_argument("--skip-frames", action="store_true",
                    help="figures + CSV only (no renders)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda")
    return ap


def experiment_rows(results: dict) -> list:
    """experiments.csv's rows (header first) from a protocol results
    dict."""
    rows = [("scene", "view_set", "method", "n", "ms", "psnr", "wpsnr",
             "ssim", "steps_per_ray")]
    for tag, sweep in results["scenes"].items():
        scene, _, _ = tag.partition("-heldout")
        vs = "heldout" if tag.endswith("-heldout") else "train"
        for method in ("baseline", "policy"):
            for pt in sweep[method]:
                rows.append((scene, vs, method, pt["n"], round(pt["ms"], 2),
                             round(pt["psnr"], 2), round(pt["wpsnr"], 2),
                             round(pt.get("ssim", 0.0), 4),
                             round(pt.get("steps", 0.0), 1)))
    return rows


def _ticks(lo: float, hi: float, n: int = 5) -> np.ndarray:
    """About ``n`` round tick values inside [lo, hi]."""
    raw = (hi - lo) / max(n - 1, 1)
    step = 10.0 ** np.floor(np.log10(raw))
    step *= min((m for m in (1, 2, 5, 10) if m * step >= raw), default=10)
    return np.arange(np.ceil(lo / step) * step, hi + 1e-9 * step, step)


def pareto_figure(scene: str, sweep: dict, verdict: dict, out_png) -> None:
    """The speed-quality Pareto plot of one scene (ms a frame against
    ROI-weighted PSNR, the fixed-step and policy series, B1 and the
    operating point ringed), drawn with PIL: the JAX script's matplotlib
    figure, at its size (5.2 x 3.6 in at 160 dpi) and palette."""
    from PIL import Image, ImageDraw

    W, H = 832, 576
    x0, x1, y0, y1 = 84, W - 24, 40, H - 64  # the axes' box
    im = Image.new("RGB", (W, H), SURFACE)
    d = ImageDraw.Draw(im)
    series = ((sweep["baseline"], C_BASE, "fixed-step"),
              (sweep["policy"], C_POL, "policy"))
    ms = np.array([p["ms"] for s, _, _ in series for p in s], np.float64)
    q = np.array([p["wpsnr"] for s, _, _ in series for p in s], np.float64)
    pad = lambda v: 0.06 * max(float(v.max() - v.min()), 1e-6)
    xl, xh = ms.min() - pad(ms), ms.max() + pad(ms)
    yl, yh = q.min() - pad(q), q.max() + pad(q)

    def at(m, w):
        return (x0 + (m - xl) / (xh - xl) * (x1 - x0),
                y1 - (w - yl) / (yh - yl) * (y1 - y0))

    for t in _ticks(xl, xh):
        x = at(t, yl)[0]
        d.line([(x, y0), (x, y1)], fill="#e6e5e0")
        d.text((x, y1 + 6), f"{t:g}", fill=INK2, anchor="ma")
    for t in _ticks(yl, yh):
        y = at(xl, t)[1]
        d.line([(x0, y), (x1, y)], fill="#e6e5e0")
        d.text((x0 - 6, y), f"{t:g}", fill=INK2, anchor="rm")
    d.rectangle([x0, y0, x1, y1], outline="#d8d7d2")
    for pts, color, _ in series:
        xy = [at(p["ms"], p["wpsnr"]) for p in pts]
        d.line(xy, fill=color, width=3)
        for x, y in xy:
            d.ellipse([x - 5, y - 5, x + 5, y + 5], fill=color,
                      outline=SURFACE)

    def ring(p, color, text, dy):
        x, y = at(p["ms"], p["wpsnr"])
        d.ellipse([x - 10, y - 10, x + 10, y + 10], outline=color, width=2)
        d.text((x + 12, y + dy), text, fill=INK2)

    b1 = next(b for b in sweep["baseline"] if b["n"] == verdict["tuned_n"])
    ring(b1, C_BASE, f"B1 (n={verdict['tuned_n']})", 4)
    if verdict.get("policy_n") is not None:
        pp = next(p for p in sweep["policy"] if p["n"] == verdict["policy_n"])
        ring(pp, C_POL, f"ours (n={verdict['policy_n']}, "
             f"{verdict['speedup']:.2f}x)", -16)
    for i, (_, color, name) in enumerate(series):
        y = y0 + 14 + 18 * i
        d.line([(x1 - 120, y), (x1 - 96, y)], fill=color, width=3)
        d.text((x1 - 90, y), name, fill=INK, anchor="lm")
    d.text(((x0 + x1) / 2, 14), f"{scene}: speed-quality Pareto", fill=INK,
           anchor="mm")
    d.text(((x0 + x1) / 2, H - 22), "ms / frame (median)", fill=INK,
           anchor="mm")
    d.text((8, y0 - 22), "ROI-weighted PSNR (dB)", fill=INK)
    im.save(out_png)


def frame_strip(sc, pol, verdict, width: int, ref_steps: int,
                n_coarse: int = 40, probe_stride: int = 4) -> np.ndarray:
    """reference | B1 | policy at the scene's first training view, float
    (width, 3 * width + 12, 3) with white 6-pixel gaps."""
    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    p = sc["params"]
    bv = roi_protocol.make_views(sc["radius"])[0]
    ref, _ = roi_policy.render_fixed(sc["mixed"], bv, p, width, width,
                                     ref_steps)
    b1, _ = roi_policy.render_fixed(sc["mixed"], bv, p, width, width,
                                    verdict["tuned_n"])
    n_pol = verdict.get("policy_n") or verdict["tuned_n"]
    ours, _ = roi_policy.render_policy(pol, sc["mixed"], sc["feat_rows"], bv,
                                       p, width, width, n_coarse, n_pol,
                                       probe_stride=probe_stride)
    tiles = [x.cpu().numpy() for x in (ref, b1, ours)]
    gap = np.full((width, 6, 3), 1.0, np.float32)
    return np.concatenate(sum(([t, gap] for t in tiles[:-1]), [])
                          + [tiles[-1]], axis=1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = pathlib.Path(args.out)
    img = out / "img"
    img.mkdir(parents=True, exist_ok=True)
    results = json.loads((DOCS / "roi_results.json").read_text())
    verdicts = {v["scene"]: v for v in results["verdicts"]}

    rows = experiment_rows(results)
    with open(out / "experiments.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    print(f"[fig] wrote {out / 'experiments.csv'} ({len(rows) - 1} rows)")

    for scene, v in verdicts.items():
        pareto_figure(scene, results["scenes"][scene], v,
                      img / f"roi_pareto_{scene}.png")
        print(f"[fig] wrote {img / f'roi_pareto_{scene}.png'}")

    if not args.skip_frames:
        import torch

        from mri_raytracer_tpu_torch.env import resolve_device
        from mri_raytracer_tpu_torch.eval import roi_protocol
        from mri_raytracer_tpu_torch.io.png import to_rgb8, write_png
        from mri_raytracer_tpu_torch.ops import roi_policy

        dev = resolve_device(args.device)
        shape = tuple(int(x) for x in args.shape.split(","))
        pol = roi_policy.load_policy(DOCS / "roi_policy.npz", device=dev)
        # Frames at the operating point the eval run recorded (the meta
        # sits next to the exported policy).
        meta_path = DOCS / "roi_policy_meta.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() \
            else {}
        n_coarse = int(meta.get("n_coarse", 40))
        # Probe stride follows the FIGURE resolution (the meta value was
        # recorded at the protocol's 1920 px).
        probe_stride = roi_protocol.auto_probe_stride(args.width)
        with torch.no_grad():
            for sc in roi_protocol.build_scenes(shape, device=dev):
                name = sc["name"]
                if name not in verdicts:
                    continue
                out_png = img / ("roi_frames_" + name + ".png")
                write_png(out_png, to_rgb8(frame_strip(
                    sc, pol, verdicts[name], args.width, args.ref_steps,
                    n_coarse=n_coarse, probe_stride=probe_stride)))
                print(f"[fig] wrote {out_png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
