"""ROI policy-renderer evaluation at the reference's reporting protocol
(port of ``scripts/roi_policy_eval.py``): train the policy (validation-
selected checkpoint), run the Pareto sweep on the benchmark scenes over a
>= 30-frame camera orbit at 1920x1080, apply the showcase-plan success rule,
and report median + bootstrap 95% CI across frames for PSNR / ROI-weighted
PSNR / SSIM and ms/frame, with the card's name and power limit.

    python -m mri_raytracer_tpu_torch.apps.roi_policy_eval
    python -m mri_raytracer_tpu_torch.apps.roi_policy_eval \\
        --policy-in docs/roi_policy.npz        # skip training

Protocol: ``docs/Methodology-ROI-Neural-Volumetric-Rendering.md:53-60``
and ``docs/showcase-plan.md:39-49``. Writes ``ROI_RESULTS.md`` (``_hard``
for the adversarial suite), ``roi_results*.json`` and the trained
``roi_policy*.npz`` under ``--out`` (default ``build/roi_policy_eval/`` of
the checkout); references are cached under ``--ref-cache`` (default
``build/roi_refs/``). Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "build" / "roi_policy_eval"
DEFAULT_REF_CACHE = REPO / "build" / "roi_refs"
DEFAULT_BUDGETS = "16,24,28,32,36,40,48,64,96"
# Training renders at train_res with this probe stride (the JAX script's).
TRAIN_STRIDE = 3


def scene_task(sc, res: int, ref_steps: int, held: bool = False):
    """(scene_tuple, params, views, refs, weights) of one scene's training
    (or held-out) views at ``res``^2, on the scene's device."""
    import torch

    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    p = sc["params"]
    dev = sc["mixed"].device
    vs = [torch.as_tensor(v).to(dev)
          for v in roi_protocol.make_views(sc["radius"], held_out=held)]
    rs, ws = [], []
    with torch.no_grad():
        for bv in vs:
            ref, _ = roi_policy.render_fixed(roi_protocol.scene_tuple(sc)[0],
                                             bv, p, res, res, ref_steps)
            rs.append(ref)
            P_img, B_img = roi_policy.project_roi_maps(sc["P"], sc["B"], bv,
                                                       p, res, res)
            ws.append(roi_policy.roi_weight_map(P_img, B_img))
    return roi_protocol.scene_tuple(sc), p, vs, rs, ws


def train_protocol_policy(scenes, generator, budgets, train_steps: int,
                          train_res: int, n_coarse: int, ref_steps: int,
                          tuned_budget: int = 64):
    """The protocol's policy training: multi-scene round robin over the
    first four scenes' training views at ``train_res``^2 (Methodology:50),
    validation on the first scene's held-out views at the operating
    budgets (about tuned / 1.8 and +-8; Methodology:53), fine budget
    ``budgets[len // 2]``. Returns (policy, losses, selection, tasks)."""
    from mri_raytracer_tpu_torch.ops import roi_policy

    tasks = [scene_task(sc, train_res, ref_steps) for sc in scenes[:4]]
    tr_sc, p, views, refs, weights = tasks[0]
    _, _, val_views, val_refs, val_weights = scene_task(
        scenes[0], train_res, ref_steps, held=True)
    op = max(16, int(round(tuned_budget / 1.8 / 4)) * 4)
    pol, losses, sel = roi_policy.train_policy(
        generator, tr_sc, views, refs, p, train_res, train_res,
        steps=train_steps, n_coarse=n_coarse,
        n_fine=budgets[len(budgets) // 2], weights=weights,
        probe_stride=TRAIN_STRIDE, extra_scenes=tasks[1:],
        val_views=val_views, val_refs=val_refs, val_weights=val_weights,
        val_budgets=(max(16, op - 8), op, op + 8))
    return pol, losses, sel, tasks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="96,96,80")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--ref-steps", type=int, default=512)
    ap.add_argument("--budgets", default=DEFAULT_BUDGETS,
                    help="fine grid around the expected operating points "
                         "(24-40): the success rule picks the fastest "
                         "qualifying budget")
    ap.add_argument("--train-steps", type=int, default=800)
    ap.add_argument("--train-res", type=int, default=96)
    ap.add_argument("--quality-frames", type=int, default=30,
                    help="orbit poses for the across-frame quality stats")
    ap.add_argument("--timing-frames", type=int, default=30)
    ap.add_argument("--n-coarse", type=int, default=48)
    ap.add_argument("--probe-stride", type=int, default=0,
                    help="0 = auto (scales with resolution)")
    ap.add_argument("--block", type=int, default=32,
                    help="sample-block size for the memory-bounded march")
    ap.add_argument("--tuned-budget", type=int, default=64)
    ap.add_argument("--suite", default="showcase",
                    choices=["showcase", "adversarial"])
    ap.add_argument("--ref-cache", default=str(DEFAULT_REF_CACHE))
    ap.add_argument("--out", default=None,
                    help=f"output directory (default {DEFAULT_OUT})")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--no-foveated", action="store_true",
                    help="skip the foveated operating points (full-res ROI "
                    "inset + half-res background)")
    ap.add_argument("--policy-in", default=None,
                    help="skip training: load this policy npz (+ its _lod "
                    "sibling if present)")
    ap.add_argument("--resume", action="store_true",
                    help="reuse per-scene sweeps already in the suite's "
                    "results JSON (scene + heldout + verdict present)")
    args = ap.parse_args(argv)

    import torch

    from mri_raytracer_tpu_torch.env import power_limit, resolve_device
    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    try:
        dev = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"[roi] {e}", file=sys.stderr)
        return 1
    card = (f"{torch.cuda.get_device_name(dev)} ({power_limit()})"
            if dev.type == "cuda" else "the CPU")
    shape = tuple(int(x) for x in args.shape.split(","))
    budgets = [int(x) for x in args.budgets.split(",")]
    stride = args.probe_stride or roi_protocol.auto_probe_stride(args.width)
    ru = roi_protocol.auto_rho_upsample(stride)
    scenes = roi_protocol.build_scenes(shape, suite=args.suite, device=dev)
    print(f"[roi] scenes: {[s['name'] for s in scenes]} device={card} "
          f"res={args.width}x{args.height} probe_stride={stride} "
          f"rho_upsample={ru}")

    R = args.train_res
    out_dir = pathlib.Path(args.out) if args.out else DEFAULT_OUT
    out_dir.mkdir(parents=True, exist_ok=True)
    pol_lod_in, tasks = None, None
    if args.policy_in:
        pol = roi_policy.load_policy(args.policy_in, device=dev)
        pin = pathlib.Path(args.policy_in)
        meta_f = pin.with_name(pin.stem + "_meta.json")
        sel = (json.loads(meta_f.read_text()).get("selection", {})
               if meta_f.exists() else {})
        sel.setdefault("selected_step", -1)
        sel.setdefault("steps_run", -1)
        losses = [float("nan"), float("nan")]
        lod_f = pin.with_name(pin.stem + "_lod.npz")
        if lod_f.exists():
            pol_lod_in = roi_policy.load_policy(lod_f, device=dev)
        print(f"[roi] loaded policy from {args.policy_in} "
              f"(lod checkpoint: {pol_lod_in is not None})")
    else:
        pol, losses, sel, tasks = train_protocol_policy(
            scenes, torch.Generator().manual_seed(0), budgets,
            args.train_steps, R, args.n_coarse, args.ref_steps,
            args.tuned_budget)
        print(f"[roi] policy trained: loss {losses[0]:.2e} -> "
              f"{losses[-1]:.2e}; selected step {sel['selected_step']}/"
              f"{sel['steps_run']} (val wPSNR {sel['best_val_wpsnr']:.2f} "
              f"dB, early_stopped={sel['early_stopped']})")
        roi_policy.save_policy(out_dir / "roi_policy.npz", pol,
                               meta={"train_steps": args.train_steps,
                                     "n_coarse": args.n_coarse,
                                     "probe_stride": stride,
                                     "selection": sel})

    # ---- protocol sweep: every scene over the orbit at full resolution;
    # the first four scenes vote on the bar. Held-out check: a disjoint
    # orbit at the operating-point budgets found on the standard orbit.
    suffix = "_hard" if args.suite == "adversarial" else ""
    results = {"losses_first_last": [losses[0], losses[-1]],
               "selection": sel, "probe_stride": stride,
               "resolution": [args.width, args.height], "device": card,
               "scenes": {}}
    verdicts = []
    results_f = out_dir / f"roi_results{suffix}.json"
    prior = {}
    if args.resume and results_f.exists():
        try:
            old = json.loads(results_f.read_text())
        except json.JSONDecodeError as e:
            print(f"[roi] resume: ignoring unreadable checkpoint ({e})",
                  file=sys.stderr)
        else:
            # Only trust a checkpoint produced at the same protocol scale.
            if old.get("resolution") == [args.width, args.height]:
                prior = old

    def checkpoint_results():
        results_f.write_text(json.dumps(results, indent=1))

    sweep_kw = dict(width=args.width, height=args.height,
                    ref_steps=args.ref_steps, n_coarse=args.n_coarse,
                    probe_stride=stride, ref_cache=args.ref_cache)
    for i, sc in enumerate(scenes):
        name = sc["name"]
        pv = next((v for v in prior.get("verdicts", [])
                   if v["scene"] == name), None)
        if (pv is not None and name in prior.get("scenes", {})
                and name + "-heldout" in prior.get("scenes", {})):
            results["scenes"][name] = prior["scenes"][name]
            results["scenes"][name + "-heldout"] = \
                prior["scenes"][name + "-heldout"]
            verdicts.append(pv)
            results["verdicts"] = verdicts
            checkpoint_results()
            print(f"[roi] {name}: resumed (speedup={pv['speedup']:.2f}x "
                  f"success={pv['success']})")
            continue
        vs = roi_protocol.make_orbit_views(sc["radius"], args.quality_frames)
        sweep = roi_protocol.pareto_sweep(
            pol, sc, vs, budgets, n_frames=args.timing_frames,
            block=args.block, foveated=not args.no_foveated, **sweep_kw)
        results["scenes"][name] = sweep
        v = roi_protocol.evaluate_success(sweep,
                                          tuned_budget=args.tuned_budget)
        v["scene"] = name
        v["counts_toward_bar"] = i < 4
        verdicts.append(v)
        print(f"[roi] {name}: speedup={v['speedup']:.2f}x "
              f"success={v['success']} (B1 n={v['tuned_n']})"
              f"{'' if i < 4 else ' [unseen-subject check]'}")

        op_budgets = sorted({v["tuned_n"]} |
                            ({v["policy_n"]} if v.get("policy_n") else set()))
        vs_h = roi_protocol.make_orbit_views(
            sc["radius"], max(15, args.quality_frames // 2), held_out=True)
        sweep_h = roi_protocol.pareto_sweep(
            pol, sc, vs_h, op_budgets, n_frames=args.timing_frames,
            block=args.block, foveated=not args.no_foveated, **sweep_kw)
        results["scenes"][name + "-heldout"] = sweep_h
        # Held-out view quality target (showcase-plan:49: <= 0.7 dB extra
        # loss) at the policy operating point, same renderer kind.
        if v.get("policy_n") is not None:
            kind = v.get("policy_kind", "policy")
            q_std = next(q for q in sweep[kind] if q["n"] == v["policy_n"])
            q_ho = next(q for q in sweep_h[kind]
                        if q["n"] == v["policy_n"])
            v["heldout_extra_loss_db"] = round(q_std["wpsnr"]
                                               - q_ho["wpsnr"], 3)
            v["heldout_ok"] = v["heldout_extra_loss_db"] <= 0.7
        results["verdicts"] = verdicts
        checkpoint_results()

    # ---- LOD ablation (Methodology:43): fine-tune the LOD head on top of
    # the selected checkpoint (training renders with the mip blend so the
    # third output gets gradient), then sweep the primary scene at the
    # operating budgets with and without the blend.
    if pol_lod_in is not None:
        pol_lod = pol_lod_in
    else:
        if tasks is None:
            tasks = [scene_task(sc, R, args.ref_steps) for sc in scenes[:4]]
        tr_sc, p, views, refs, weights = tasks[0]
        # lr: Adam's step is ~lr, and the LOD logit must travel O(1) from
        # neutral within a few hundred steps.
        pol_lod, lod_losses, _ = roi_policy.train_policy(
            torch.Generator().manual_seed(1), tr_sc, views, refs,
            p, R, R, steps=max(200, args.train_steps // 4),
            n_coarse=args.n_coarse, n_fine=budgets[len(budgets) // 2],
            weights=weights, lr=5e-3, probe_stride=TRAIN_STRIDE,
            extra_scenes=tasks[1:], init=pol,
            lod_vols=[sc["mixed_p1"] for sc in scenes[:4]])
        print(f"[roi] LOD fine-tune: loss {lod_losses[0]:.2e} -> "
              f"{lod_losses[-1]:.2e}")
        roi_policy.save_policy(out_dir / "roi_policy_lod.npz", pol_lod,
                               meta={"finetuned_from": "roi_policy.npz",
                                     "lod": True})
    v0 = verdicts[0]
    ab_budgets = sorted({v0["tuned_n"]} |
                        ({v0["policy_n"]} if v0.get("policy_n") else set()))
    vs0 = roi_protocol.make_orbit_views(scenes[0]["radius"],
                                        max(10, args.quality_frames // 3))
    try:
        # The LOD blend holds both the fine and the mip gathers per sample
        # block: block // 4 keeps the 1080p ablation's peak memory down.
        sweep_lod = roi_protocol.pareto_sweep(
            pol, scenes[0], vs0, ab_budgets,
            n_frames=max(6, args.timing_frames // 3),
            block=max(8, args.block // 4), lod=True, policy_lod=pol_lod,
            **sweep_kw)
        results["lod_ablation"] = sweep_lod
        pl_, plod = sweep_lod["policy"][-1], sweep_lod["policy_lod"][-1]
        lod_line = (f"LOD ablation ({scenes[0]['name']}, n={pl_['n']}, "
                    f"fine-tuned head): policy "
                    f"{pl_['wpsnr']:.2f} dB wPSNR / {pl_['ms']:.1f} ms -> "
                    f"+LOD {plod['wpsnr']:.2f} dB / {plod['ms']:.1f} ms "
                    f"(delta {plod['wpsnr'] - pl_['wpsnr']:+.2f} dB, "
                    f"{plod['ms'] - pl_['ms']:+.1f} ms).")
        print(f"[roi] {lod_line}")
    except torch.OutOfMemoryError as e:  # the ablation is optional
        lod_line = f"LOD ablation skipped ({type(e).__name__})."
        print(f"[roi] LOD ablation failed: {e}", file=sys.stderr)

    n_ok = sum(v["success"] for v in verdicts if v["counts_toward_bar"])
    results["verdicts"] = verdicts
    results["success_bar"] = {"target": ">=1.8x at <=0.5 dB on >=3/4 scenes",
                              "scenes_passing": n_ok,
                              "overall": n_ok >= 3}
    print(f"[roi] OVERALL: {n_ok}/4 scenes pass the 1.8x bar -> "
          f"{'SUCCESS' if n_ok >= 3 else 'FAIL'} (times on {card})")
    checkpoint_results()
    md = out_dir / ("ROI_RESULTS_hard.md" if suffix else "ROI_RESULTS.md")
    roi_protocol.write_report(results, md, suite=args.suite,
                              lod_line=lod_line)
    print(f"[roi] wrote {md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
