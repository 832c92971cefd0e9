"""Live in-training dashboard (own copy of ``io/dashboard.py``; reference
O6, ``notebooks/jax_inr_training_wandb_improved.py:655-706``).

The reference redraws, inside the notebook on every refresh: a twin-axis
loss + per-class-Dice curve plot and a GT-vs-prediction slice pair. This
module reproduces that as a matplotlib figure that works in three modes:

  * headless (default): the figure is written to ``<out>/dashboard.png`` on
    every refresh — tail it with any image viewer while training runs;
  * notebook: pass ``notebook=True`` to redraw in-place via
    ``IPython.display`` (``clear_output`` like the reference);
  * off: construct with ``enabled=False`` — every call is a no-op.

Matplotlib is import-gated like wandb: a missing/broken install degrades to
no-op rather than killing training.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Optional

import numpy as np

SEG_CMAP = np.array([[0.0, 0.0, 0.0],  # background
                     [0.9, 0.2, 0.2],  # necrotic core
                     [0.2, 0.9, 0.2],  # edema
                     [1.0, 0.65, 0.0]])  # enhancing


def label_overlay(gray: np.ndarray, labels: np.ndarray,
                  alpha: float = 0.55) -> np.ndarray:
    """(H, W) intensity in [0,1] + (H, W) int labels -> (H, W, 3) overlay."""
    g = np.clip(np.asarray(gray, np.float32), 0.0, 1.0)
    rgb = np.repeat(g[..., None], 3, axis=-1)
    lab = np.clip(np.asarray(labels, np.int32), 0, len(SEG_CMAP) - 1)
    color = SEG_CMAP[lab]
    mask = (lab > 0)[..., None].astype(np.float32) * alpha
    return rgb * (1.0 - mask) + color * mask


class TrainingDashboard:
    def __init__(self, out_dir, num_classes: int = 4, enabled: bool = True,
                 notebook: bool = False):
        self.enabled = enabled
        self.notebook = notebook
        self.out_path = pathlib.Path(out_dir) / "dashboard.png"
        self.steps: List[int] = []
        self.losses: List[float] = []
        self.dice: List[np.ndarray] = []
        self.num_classes = num_classes
        self._plt = None
        if enabled:
            try:
                import matplotlib

                if not notebook:
                    matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                self._plt = plt
            except Exception as e:  # never kill training over a plot
                print(f"[dashboard] matplotlib unavailable: {e}")
                self.enabled = False

    def update(self, step: int, loss: float, dice_per_class,
               gt_slice: Optional[np.ndarray] = None,
               pred_slice: Optional[np.ndarray] = None,
               intensity_slice: Optional[np.ndarray] = None) -> None:
        """Append one point and redraw (loss curve + per-class Dice on a twin
        axis; GT vs predicted slice overlays when provided)."""
        if not self.enabled:
            return
        self.steps.append(int(step))
        self.losses.append(float(loss))
        self.dice.append(np.asarray(dice_per_class, np.float32))
        plt = self._plt

        have_imgs = gt_slice is not None and pred_slice is not None
        fig, axes = plt.subplots(1, 3 if have_imgs else 1,
                                 figsize=(15 if have_imgs else 6, 4.5))
        ax0 = axes[0] if have_imgs else axes
        ax0.plot(self.steps, self.losses, "b-", label="loss")
        ax0.set_xlabel("step")
        ax0.set_ylabel("loss", color="b")
        ax0.tick_params(axis="y", labelcolor="b")
        ax1 = ax0.twinx()
        d = np.stack(self.dice)
        for c in range(1, min(self.num_classes, d.shape[1])):
            ax1.plot(self.steps, d[:, c], label=f"dice c{c}")
        ax1.set_ylabel("dice")
        ax1.set_ylim(0.0, 1.0)
        ax1.legend(loc="lower right", fontsize=8)
        ax0.set_title(f"step {step}: loss {self.losses[-1]:.4f}")

        if have_imgs:
            base = (np.clip(intensity_slice, 0, 1)
                    if intensity_slice is not None
                    else np.zeros_like(np.asarray(gt_slice), np.float32))
            axes[1].imshow(label_overlay(base, gt_slice))
            axes[1].set_title("ground truth")
            axes[1].axis("off")
            axes[2].imshow(label_overlay(base, pred_slice))
            axes[2].set_title("prediction")
            axes[2].axis("off")

        fig.tight_layout()
        if self.notebook:
            try:
                from IPython import display

                display.clear_output(wait=True)
                display.display(fig)
            except Exception:
                fig.savefig(self.out_path, dpi=90)
        else:
            fig.savefig(self.out_path, dpi=90)
        plt.close(fig)

    def history(self) -> Dict[str, list]:
        return {"steps": self.steps, "loss": self.losses,
                "dice": [d.tolist() for d in self.dice]}
