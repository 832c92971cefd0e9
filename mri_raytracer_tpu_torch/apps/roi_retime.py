"""Interleaved re-timing of the ROI protocol's verdict operating points
(port of ``scripts/roi_retime.py``).

The protocol sweep times the tuned baseline and the policy operating point
in sequential phases, and the host's drift between phases can exceed a
1.79x-against-1.80x verdict margin. This re-times ONLY the two points each
scene's verdict names, with interleaved A/B batches (baseline and policy
alternate inside every round, so each speedup sample shares one drift
window), and updates the verdict with the interleaved median speedup and
its bootstrap CI; quality numbers stay (deterministic renders) unless
``--requality`` re-renders them against the cached references.

    python -m mri_raytracer_tpu_torch.apps.roi_retime --scenes tumor-a --dry-run

Reads ``--results`` (default the repo's ``docs/roi_results{_hard}.json``)
and the policy beside it; writes the updated results and its report to a
COPY under ``--out`` (default ``build/roi_retime/``), never over the input.
References are cached under ``--ref-cache`` (default ``build/roi_refs/``).
Runs on the card unless ``--cpu`` is given; no kernel of the port.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "build" / "roi_retime"
DEFAULT_REF_CACHE = REPO / "build" / "roi_refs"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="interleaved re-timing of the "
                                 "ROI verdicts (PyTorch/CUDA)")
    ap.add_argument("--results", default=None,
                    help="protocol JSON to re-time (default: "
                    "docs/roi_results.json, or _hard for --suite "
                    "adversarial); the update is written under --out")
    ap.add_argument("--suite", default="showcase",
                    choices=["showcase", "adversarial"])
    ap.add_argument("--scenes", default=None,
                    help="comma list; default = every scene whose verdict "
                    "has an operating point")
    ap.add_argument("--shape", default="96,96,80")
    ap.add_argument("--rounds", type=int, default=20,
                    help="interleaved A/B rounds (3 frames per side each)")
    ap.add_argument("--n-coarse", type=int, default=48)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--policy-in", default=None,
                    help="default: roi_policy.npz next to the results file")
    ap.add_argument("--requality", action="store_true",
                    help="also re-render the policy operating point over "
                    "the quality frames and refresh its wpsnr/ssim against "
                    "the cached references")
    ap.add_argument("--ref-cache", default=str(DEFAULT_REF_CACHE))
    ap.add_argument("--dry-run", action="store_true",
                    help="measure and print, but write no JSON/markdown")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def timed_pair(fa, fb, rounds: int) -> list:
    """Interleaved per-round (baseline ms, policy ms): 3 frames of A then
    3 of B a round, one sync a batch."""
    from mri_raytracer_tpu_torch.utils.profiling import batch_times, sync

    sync(fa())  # warm
    sync(fb())
    return [(1e3 * batch_times(fa, 3, 1, warm=False)[0],
             1e3 * batch_times(fb, 3, 1, warm=False)[0])
            for _ in range(rounds)]


def retime_verdict(v: dict, sweep: dict, sc, pol, args) -> None:
    """Re-time (and with ``--requality`` re-measure) one verdict, in
    place."""
    import torch

    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    name = v["scene"]
    w, h = sweep["width"], sweep["height"]
    stride = sweep.get("probe_stride", 1)
    ru = sweep.get("rho_upsample")
    # Reproduce the sweep's renderer configuration; older sweeps did not
    # record n_coarse/block, and then the CLI values are used.
    n_coarse = sweep.get("n_coarse")
    blk = sweep.get("block")
    if n_coarse is None or blk is None:
        print(f"[retime] {name}: sweep predates n_coarse/block recording; "
              f"assuming n_coarse={args.n_coarse} block={args.block}",
              file=sys.stderr)
        n_coarse = args.n_coarse if n_coarse is None else n_coarse
        blk = args.block if blk is None else blk
    p = sc["params"]
    st = roi_protocol.scene_tuple(sc)
    dev = st[0].device
    views = roi_protocol.make_orbit_views(sc["radius"],
                                          sweep.get("quality_frames", 30))
    bv0 = torch.as_tensor(views[0], device=dev)
    kind = v.get("policy_kind", "policy")
    n_b, n_p = v["tuned_n"], v["policy_n"]

    def f_base(bv=bv0):
        return roi_policy.render_fixed(st[0], bv, p, w, h, n_b, block=blk)[0]

    if kind == "policy_fov":
        corners = torch.as_tensor(
            roi_policy.roi_world_corners(sc["P"], sc["B"], p), device=dev)

        def f_pol(bv=bv0):
            return roi_policy.render_policy_foveated(
                pol, *st, bv, p, w, h, corners, n_coarse, n_p,
                probe_stride=stride, block=blk, rho_upsample=ru)[0]
    else:
        def f_pol(bv=bv0):
            return roi_policy.render_policy(
                pol, *st, bv, p, w, h, n_coarse, n_p,
                roi_policy.PolicyConfig(), probe_stride=stride, block=blk,
                rho_upsample=ru)[0]

    pairs = timed_pair(f_base, f_pol, args.rounds)
    a = np.array([x for x, _ in pairs])
    b = np.array([y for _, y in pairs])
    sp = roi_protocol.median_ci(list(a / b))
    old = v["speedup"]
    v["speedup_sequential"] = old
    v["speedup"] = sp["median"]
    v["speedup_ci"] = sp["ci95"]
    v["tuned_ms"] = float(np.median(a))
    v["policy_ms"] = float(np.median(b))
    v["timing_method"] = (f"interleaved A/B, {args.rounds} rounds x "
                          f"3+3 frames")

    quality_ok = (v.get("policy_wpsnr", float("inf"))
                  >= v.get("bar_db", float("-inf")))
    if args.requality:
        wp, ss = [], []
        for bv in views:
            ref = roi_protocol._render_ref(
                sc, bv, p, w, h, sweep.get("ref_steps", 512), blk,
                args.ref_cache, name)
            wmap = roi_protocol._wmap_for(sc, bv, p, w, h)
            q = roi_protocol._metrics_of(
                f_pol(torch.as_tensor(bv, device=dev)), ref, wmap)
            wp.append(q[1])
            ss.append(q[2])
        wq = roi_protocol.median_ci(wp)
        sq = roi_protocol.median_ci(ss)
        v["policy_wpsnr_presweep"] = v.get("policy_wpsnr")
        v["policy_wpsnr"] = wq["median"]
        v["policy_wpsnr_ci"] = wq["ci95"]
        v["policy_ssim"] = sq["median"]
        v["policy_ssim_ci"] = sq["ci95"]
        quality_ok = wq["median"] >= v["bar_db"]
        print(f"[retime] {name} requality: wpsnr "
              f"{v['policy_wpsnr_presweep']} -> {wq['median']:.2f} dB "
              f"(bar {v['bar_db']:.2f}), ssim {sq['median']:.5f}")
    v["success"] = bool(sp["median"] >= 1.8 and quality_ok)
    print(f"[retime] {name} ({kind} n={n_p} vs B1 n={n_b}): "
          f"{old:.4f}x (sequential) -> {sp['median']:.4f}x "
          f"[{sp['ci95'][0]:.4f}, {sp['ci95'][1]:.4f}] interleaved; "
          f"base {np.median(a):.1f} ms, policy {np.median(b):.1f} ms, "
          f"success={v['success']}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    dev = resolve_device("cpu" if args.cpu else "cuda")
    suffix = "_hard" if args.suite == "adversarial" else ""
    results_f = pathlib.Path(args.results or
                             REPO / "docs" / f"roi_results{suffix}.json")
    results = json.loads(results_f.read_text())
    verdicts = results.get("verdicts", [])
    if not verdicts:
        print("[retime] no verdicts in", results_f, file=sys.stderr)
        return 1
    pol_f = pathlib.Path(args.policy_in or results_f.parent / "roi_policy.npz")
    pol = roi_policy.load_policy(pol_f, device=dev)
    shape = tuple(int(x) for x in args.shape.split(","))
    scenes = {s["name"]: s for s in roi_protocol.build_scenes(
        shape, suite=args.suite, device=dev)}
    want = (set(args.scenes.split(",")) if args.scenes
            else {v["scene"] for v in verdicts
                  if v.get("policy_n") is not None})

    changed = False
    with torch.no_grad():
        for v in verdicts:
            name = v["scene"]
            if name not in want or v.get("policy_n") is None:
                continue
            sc = scenes.get(name)
            if sc is None:
                print(f"[retime] scene {name} not in suite {args.suite}; "
                      "skip")
                continue
            retime_verdict(v, results["scenes"][name], sc, pol, args)
            changed = True

    if not changed:
        print("[retime] nothing re-timed")
        return 0
    n_ok = sum(bool(v["success"]) for v in verdicts
               if v.get("counts_toward_bar"))
    results["verdicts"] = verdicts
    results["success_bar"] = {
        "target": ">=1.8x at <=0.5 dB on >=3/4 scenes",
        "scenes_passing": n_ok, "overall": n_ok >= 3}
    print(f"[retime] OVERALL: {n_ok}/4 scenes pass the 1.8x bar -> "
          f"{'SUCCESS' if n_ok >= 3 else 'FAIL'}")
    if args.dry_run:
        return 0
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    out_f = out / results_f.name
    if out_f.resolve() == results_f.resolve():
        raise SystemExit(f"--out would overwrite {results_f}; the update "
                         "goes to a copy")
    out_f.write_text(json.dumps(results, indent=1))
    md = out / ("ROI_RESULTS_hard.md" if suffix else "ROI_RESULTS.md")
    roi_protocol.write_report(results, md, suite=args.suite)
    print(f"[retime] wrote {out_f} and {md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
