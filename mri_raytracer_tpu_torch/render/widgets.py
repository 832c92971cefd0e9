"""Notebook viewers (port of ``render/widgets.py``; reference H9-H11).

  * ``SliceViewer`` — ipywidgets axial/coronal/sagittal browser with
    modality blend weights, WW/WL windowing, and RGBA seg/pred overlays
    (reference ``notebooks/MRI_Viewer.ipynb §2-8``)
  * ``HoldoutViewer`` — case dropdown + z slider with per-slice Dice/PSNR
    annotations and cached predictions (reference ``inr/interactive.ipynb §5``)
  * ``OrbitViewer`` — interactive 3-D widget driving a ``BratsRenderer``
    (the notebook stand-in for the reference's SlangPy window loop)

Every class exposes a pure-array ``render_*``/``frame`` method, so it is
usable headlessly; ipywidgets, IPython and matplotlib are imported only
inside ``show()``. The slice work is host NumPy, as in the JAX package; the
hold-out prediction runs on the viewer's device (``cuda`` unless given) and
the orbit frame on its renderer's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from mri_raytracer_tpu_torch.render.params import DEFAULT_LUT

AXIS_NAMES = {"axial": 2, "coronal": 1, "sagittal": 0}


def window_level(img: np.ndarray, ww: float, wl: float) -> np.ndarray:
    return np.clip((img - (wl - 0.5 * ww)) / max(ww, 1e-6), 0.0, 1.0)


def overlay_labels(gray: np.ndarray, labels: Optional[np.ndarray],
                   lut: np.ndarray = DEFAULT_LUT,
                   opacity_scale: float = 1.0) -> np.ndarray:
    """Alpha-blend the class LUT over a grayscale slice -> (H, W, 3)."""
    rgb = np.repeat(gray[..., None], 3, axis=-1)
    if labels is None:
        return rgb
    safe = np.where((labels > 0) & (labels < 8), labels, 0)
    col = lut[safe]  # (..., 4)
    a = np.clip(col[..., 3] * opacity_scale, 0.0, 1.0)[..., None]
    return rgb * (1 - a) + col[..., :3] * a


class SliceViewer:
    """2-D slice browser over a (M, X, Y, Z) display-normalized volume."""

    def __init__(self, mods: np.ndarray, seg: Optional[np.ndarray] = None,
                 pred: Optional[np.ndarray] = None,
                 modality_names: Sequence[str] = ("t1n", "t1c", "t2w", "t2f")):
        self.mods = np.asarray(mods, np.float32)
        self.seg = seg
        self.pred = pred
        self.names = list(modality_names)[: self.mods.shape[0]]

    def render_slice(self, axis: str = "axial", index: int = 0,
                     weights: Optional[Sequence[float]] = None,
                     ww: float = 1.0, wl: float = 0.5, show_seg: bool = True,
                     show_pred: bool = False) -> np.ndarray:
        ax = AXIS_NAMES[axis]
        w = np.asarray(weights if weights is not None
                       else [1.0] * self.mods.shape[0], np.float32)
        wsum = max(float(w.sum()), 1e-6)
        blend = np.tensordot(w / wsum, self.mods, axes=(0, 0))
        sl = np.take(blend, index, axis=ax)
        gray = window_level(sl, ww, wl)
        lab = None
        if show_seg and self.seg is not None:
            lab = np.take(self.seg, index, axis=ax)
        img = overlay_labels(gray, lab)
        if show_pred and self.pred is not None:
            img = overlay_labels(img.mean(-1), np.take(self.pred, index, axis=ax),
                                 opacity_scale=0.8)
        return img

    def render_multiview(self, index_frac: float = 0.5, **kw) -> np.ndarray:
        """Axial/coronal/sagittal side-by-side grid (reference multi-view)."""
        panels = []
        hmax = 0
        for axis in ("axial", "coronal", "sagittal"):
            ax = AXIS_NAMES[axis]
            idx = int(index_frac * (self.mods.shape[1 + ax] - 1))
            panels.append(self.render_slice(axis, idx, **kw))
            hmax = max(hmax, panels[-1].shape[0])
        padded = [np.pad(p, ((0, hmax - p.shape[0]), (0, 0), (0, 0)))
                  for p in panels]
        return np.concatenate(padded, axis=1)

    def show(self):  # pragma: no cover - notebook only
        import ipywidgets as widgets
        from IPython.display import display
        import matplotlib.pyplot as plt

        axis_dd = widgets.Dropdown(options=list(AXIS_NAMES), value="axial")
        idx_sl = widgets.IntSlider(0, 0, self.mods.shape[3] - 1, description="slice")
        ww_sl = widgets.FloatSlider(1.0, min=0.01, max=2.0, description="WW")
        wl_sl = widgets.FloatSlider(0.5, min=0.0, max=1.0, description="WL")
        seg_cb = widgets.Checkbox(self.seg is not None, description="GT seg")
        pred_cb = widgets.Checkbox(False, description="INR pred")
        w_sliders = [widgets.FloatSlider(1.0, min=0, max=2, description=n)
                     for n in self.names]
        out = widgets.Output()

        def redraw(*_):
            ax = AXIS_NAMES[axis_dd.value]
            idx_sl.max = self.mods.shape[1 + ax] - 1
            img = self.render_slice(axis_dd.value, idx_sl.value,
                                    [s.value for s in w_sliders],
                                    ww_sl.value, wl_sl.value,
                                    seg_cb.value, pred_cb.value)
            with out:
                out.clear_output(wait=True)
                plt.figure(figsize=(5, 5))
                plt.imshow(img)
                plt.axis("off")
                plt.show()

        for wdg in [axis_dd, idx_sl, ww_sl, wl_sl, seg_cb, pred_cb] + w_sliders:
            wdg.observe(redraw, "value")
        display(widgets.VBox([widgets.HBox([axis_dd, idx_sl]),
                              widgets.HBox([ww_sl, wl_sl, seg_cb, pred_cb]),
                              widgets.HBox(w_sliders), out]))
        redraw()


class HoldoutViewer:
    """Per-case hold-out browser with slice Dice/PSNR annotations and a
    prediction cache (reference ``load_and_predict_cached``). The
    prediction runs on ``device`` (``cuda`` unless given), where
    ``params`` is moved."""

    def __init__(self, model, params, cases: List[Dict[str, np.ndarray]],
                 device=None):
        from mri_raytracer_tpu_torch.env import resolve_device

        self.device = resolve_device(device)
        self.model = model
        self.params = params.to(self.device)
        self.cases = cases
        self._pred_cache: Dict[int, np.ndarray] = {}

    def prediction(self, case_idx: int) -> np.ndarray:
        if case_idx not in self._pred_cache:
            from mri_raytracer_tpu_torch.eval.inference import predict_volume

            pred, _ = predict_volume(self.model, self.params,
                                     self.cases[case_idx],
                                     device=self.device)
            self._pred_cache[case_idx] = pred
        return self._pred_cache[case_idx]

    def slice_report(self, case_idx: int, z: int) -> Dict[str, float]:
        from mri_raytracer_tpu_torch.eval import metrics

        case = self.cases[case_idx]
        pred = self.prediction(case_idx)
        true = np.asarray(case["seg"])
        dice = metrics.macro_slice_dice(pred[..., z], true[..., z])
        # PSNR of the class map as a coarse agreement proxy (reference E7)
        ps = metrics.psnr(pred[..., z].astype(np.float32) / 3.0,
                          true[..., z].astype(np.float32) / 3.0)
        return {"macro_dice": dice, "psnr": ps}

    def render(self, case_idx: int, z: int) -> np.ndarray:
        case = self.cases[case_idx]
        gray = np.asarray(case["mods"][0, :, :, z])
        gray = (gray - gray.min()) / max(np.ptp(gray), 1e-6)
        gt = overlay_labels(gray, np.asarray(case["seg"][:, :, z]))
        pr = overlay_labels(gray, self.prediction(case_idx)[:, :, z])
        return np.concatenate([gt, pr], axis=1)

    def show(self):  # pragma: no cover - notebook only
        import ipywidgets as widgets
        from IPython.display import display
        import matplotlib.pyplot as plt

        case_dd = widgets.Dropdown(
            options=[(c.get("name", f"case {i}"), i)
                     for i, c in enumerate(self.cases)])
        z_sl = widgets.IntSlider(0, 0, self.cases[0]["seg"].shape[-1] - 1,
                                 description="z")
        out = widgets.Output()

        def redraw(*_):
            rep = self.slice_report(case_dd.value, z_sl.value)
            img = self.render(case_dd.value, z_sl.value)
            with out:
                out.clear_output(wait=True)
                plt.figure(figsize=(8, 4))
                plt.imshow(img)
                plt.title(f"GT | pred — dice={rep['macro_dice']:.3f} "
                          f"psnr={rep['psnr']:.1f}dB")
                plt.axis("off")
                plt.show()

        case_dd.observe(redraw, "value")
        z_sl.observe(redraw, "value")
        display(widgets.VBox([widgets.HBox([case_dd, z_sl]), out]))
        redraw()


class OrbitViewer:
    """3-D orbit widget over a ``BratsRenderer`` (notebook analog of the
    60 Hz SlangPy window loop): on a card its frame is stage 1, K1 and K2."""

    def __init__(self, renderer, params, camera):
        self.renderer = renderer
        self.params = params
        self.camera = camera

    def frame(self) -> np.ndarray:
        return np.clip(self.renderer.render_numpy(self.camera.basis(),
                                                  self.params), 0, 1)

    def show(self):  # pragma: no cover - notebook only
        import ipywidgets as widgets
        from IPython.display import display
        import matplotlib.pyplot as plt

        theta = widgets.FloatSlider(self.camera.theta, min=-6.3, max=6.3,
                                    step=0.05, description="theta")
        phi = widgets.FloatSlider(self.camera.phi, min=0.05, max=3.1,
                                  step=0.05, description="phi")
        zoom = widgets.FloatSlider(self.camera.radius, min=0.2, max=10,
                                   step=0.1, description="radius")
        out = widgets.Output()

        def redraw(*_):
            self.camera.theta = theta.value
            self.camera.phi = phi.value
            self.camera.radius = zoom.value
            with out:
                out.clear_output(wait=True)
                plt.figure(figsize=(6, 6))
                plt.imshow(self.frame())
                plt.axis("off")
                plt.show()

        for w in (theta, phi, zoom):
            w.observe(redraw, "value")
        display(widgets.VBox([widgets.HBox([theta, phi, zoom]), out]))
        redraw()
