#!/usr/bin/env python3
"""CPU evidence behind two of ``chip_smoke.py``'s ``[roi]`` gates, from the
JAX package and the port side by side (no card; JAX on the CPU).

    JAX_PLATFORMS=cpu python3 tools/roi_gate_evidence.py lod     # ~2 min
    JAX_PLATFORMS=cpu python3 tools/roi_gate_evidence.py train   # ~5 min

``lod``: the LOD series' loss against the plain policy in float32. tumor-a
of the showcase scenes at 480 x 270 (probe stride 8, rho_upsample 2, 48
probes, n = 64, block 8), four poses of the 30-pose orbit; the median
ROI-weighted PSNR of ``docs/roi_policy.npz`` and of ``docs/roi_policy_lod.npz``
with the mip blend, against the 512-step reference, in each package.

``train``: the protocol's policy training (800 steps at 96^2, four scenes,
validation on tumor-a's held-out views) in the port from ``torch``
generators seeded 0 and 1 and from the JAX package's
``init_policy(PRNGKey(0))``, and in the JAX package from its own
``PRNGKey(0)``: the mean loss over the first and the last lap of (scene,
view) pairs, the selected step and the best validation wPSNR.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def lod() -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mri_raytracer_tpu.eval import roi_protocol as JP
    from mri_raytracer_tpu.ops import roi_policy as J
    from mri_raytracer_tpu_torch.eval import roi_protocol as TP
    from mri_raytracer_tpu_torch.ops import roi_policy as T

    W, H, S, RU, N = 480, 270, 8, 2, 64
    js = JP.build_scenes((96, 96, 80))[0]
    ts = TP.build_scenes((96, 96, 80), device="cpu")[0]
    kw = dict(probe_stride=S, block=8, rho_upsample=RU)
    pols = {"jax": [J.load_policy(f"docs/{n}.npz")
                    for n in ("roi_policy", "roi_policy_lod")],
            "port": [T.load_policy(f"docs/{n}.npz")
                     for n in ("roi_policy", "roi_policy_lod")]}
    q = {"jax": [], "port": []}
    for bv in JP.make_orbit_views(js["radius"], 30)[::6][:4]:
        jb = jnp.asarray(bv)
        ref = J.render_fixed(js["mixed_p"], jb, js["params"], W, H, 512,
                             block=32)[0]
        w = JP._wmap_for(js, jb, js["params"], W, H)
        a, b = (J.render_policy(pol, js["mixed_p"], js["feat_rows"], jb,
                                js["params"], W, H, 48, N,
                                lod_vol=lv, **kw)[0]
                for pol, lv in zip(pols["jax"], (None, js["mixed_p1"])))
        q["jax"].append((JP._metrics_of(a, ref, w)[1],
                         JP._metrics_of(b, ref, w)[1]))
        tb = torch.from_numpy(bv)
        tref = torch.from_numpy(np.asarray(ref))
        tw = torch.from_numpy(np.asarray(w))
        with torch.no_grad():
            a, b = (T.render_policy(pol, ts["mixed_p"], ts["feat_rows"], tb,
                                    ts["params"], W, H, 48, N, lod_vol=lv,
                                    **kw)[0]
                    for pol, lv in zip(pols["port"], (None, ts["mixed_p1"])))
        q["port"].append((TP._metrics_of(a, tref, tw)[1],
                          TP._metrics_of(b, tref, tw)[1]))
    for k, v in q.items():
        v = np.array(v)
        print(f"lod {k}: median wPSNR policy {np.median(v[:, 0]):.2f} dB, "
              f"+LOD {np.median(v[:, 1]):.2f} dB, median delta "
              f"{np.median(v[:, 1] - v[:, 0]):+.2f} dB ({len(v)} poses, "
              f"{W}x{H}, the CPU)")


def train() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mri_raytracer_tpu.eval import roi_protocol as JP
    from mri_raytracer_tpu.ops import roi_policy as J
    from mri_raytracer_tpu_torch.apps import roi_policy_eval as app
    from mri_raytracer_tpu_torch.eval import roi_protocol as TP
    from mri_raytracer_tpu_torch.ops import roi_policy as T

    budgets = [int(x) for x in app.DEFAULT_BUDGETS.split(",")]

    def report(name, losses, sel):
        L = np.asarray(losses)
        print(f"train {name}: loss over the first / last 12 steps "
              f"{L[:12].mean():.5e} / {L[-12:].mean():.5e} "
              f"({100 * (L[-12:].mean() / L[:12].mean() - 1):+.2f}%), "
              f"{sel['steps_run']} steps, selected step "
              f"{sel['selected_step']}, best validation wPSNR "
              f"{sel['best_val_wpsnr']:.3f} dB", flush=True)

    scenes = TP.build_scenes((96, 96, 80), device="cpu")
    init = {k: torch.from_numpy(np.asarray(v))
            for k, v in J.init_policy(jax.random.PRNGKey(0)).items()}
    for name, seed, start in (("port, torch seed 0", 0, None),
                              ("port, torch seed 1", 1, None),
                              ("port, JAX's PRNGKey(0) init", 0, init)):
        orig = T.train_policy
        if start is not None:
            T.train_policy = lambda *a, **k: orig(*a, init=start, **k)
        try:
            _, losses, sel, _ = app.train_protocol_policy(
                scenes, torch.Generator().manual_seed(seed), budgets, 800,
                96, 48, 512)
        finally:
            T.train_policy = orig
        report(name, losses, sel)

    jscenes = JP.build_scenes((96, 96, 80))

    def task(sc, held=False):
        vs = [jnp.asarray(v) for v in JP.make_views(sc["radius"], held)]
        rs, ws = [], []
        for bv in vs:
            rs.append(J.render_fixed(JP.scene_tuple(sc)[0], bv, sc["params"],
                                     96, 96, 512)[0])
            P, B = J.project_roi_maps(sc["P"], sc["B"], bv, sc["params"],
                                      96, 96)
            ws.append(J.roi_weight_map(P, B))
        return JP.scene_tuple(sc), sc["params"], vs, rs, ws

    tasks = [task(sc) for sc in jscenes[:4]]
    _, _, vv, vr, vw = task(jscenes[0], held=True)
    _, losses, sel = J.train_policy(
        jax.random.PRNGKey(0), tasks[0][0], *tasks[0][2:4], tasks[0][1], 96,
        96, steps=800, n_coarse=48, n_fine=budgets[len(budgets) // 2],
        weights=tasks[0][4], probe_stride=3, extra_scenes=tasks[1:],
        val_views=vv, val_refs=vr, val_weights=vw, val_budgets=(28, 36, 44))
    report("JAX, PRNGKey(0)", losses, sel)


if __name__ == "__main__":
    import torch

    torch.set_num_threads(4)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["lod", "train"])
    {"lod": lod, "train": train}[ap.parse_args().what]()
