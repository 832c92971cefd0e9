"""Runs of the harness, on the CPU at a small case, with the timed path
broken underneath: each fault a cell can have must come out not correct.
(A one-chip cell has no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _stale(monkeypatch, cell):
    """Every frame after the first returns the first one: a step that
    returns its state unchanged."""
    from mri_raytracer_tpu_torch.ops.neural_march import NeuralBratsRenderer
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer

    for cls in (BratsRenderer, NeuralBratsRenderer):
        orig = cls.render_numpy

        def stale(self, basis, p, orig=orig):
            if not hasattr(self, "_first"):
                self._first = orig(self, basis, p)
            return self._first.copy()
        monkeypatch.setattr(cls, "render_numpy", stale)


def _k1_state_unchanged(monkeypatch, cell):
    """K1 hands back its initial state: nothing composited."""
    from mri_raytracer_tpu_torch.ops import composite

    orig = composite.composite_planes

    def unchanged(t1b, *args, **kw):
        out = orig(t1b, *args, **kw)
        return (torch.zeros_like(out[0]), torch.ones_like(out[1]),
                *out[2:])
    monkeypatch.setattr(composite, "composite_planes", unchanged)


def _half_planes(monkeypatch, cell):
    """Stage 1 leaves every other plane out."""
    from mri_raytracer_tpu_torch.ops import composite

    orig = composite.stage1

    def half(*args, **kw):
        k1 = orig(*args, **kw)
        t1b = k1.t1b.clone()
        t1b[1::2] = 0
        rows = None if k1.seg_rows is None else k1.seg_rows.clone()
        if rows is not None:
            rows[1::2] = 0
        return k1._replace(t1b=t1b, seg_rows=rows)
    monkeypatch.setattr(composite, "stage1", half)


def _half_rows_mean(monkeypatch, cell):
    """The warp leaves half of the frame's rows out and fills them with
    the mean of the rest."""
    from mri_raytracer_tpu_torch.ops import warp

    orig = warp.warp_screen

    def half(C, s, axis, width, height):
        out = orig(C, s, axis, width, height).clone()
        out[height // 2:] = out[:height // 2].mean(dim=(0, 1))
        return out
    monkeypatch.setattr(warp, "warp_screen", half)


def _answer_altered(monkeypatch, cell):
    """Labels altered where they are produced: the INR's field, or the
    ground truth's label rows."""
    from mri_raytracer_tpu_torch.ops import composite, neural_march

    if cell == "tiny.inr":
        orig = neural_march.predict_field

        def altered(*args, **kw):
            return (orig(*args, **kw) + 1) % 4
        monkeypatch.setattr(neural_march, "predict_field", altered)
    else:
        orig = composite.stage1

        def altered(*args, **kw):
            k1 = orig(*args, **kw)
            return k1._replace(seg_rows=(k1.seg_rows % 3) + 1)
        monkeypatch.setattr(composite, "stage1", altered)


FAULTS = {"stale_frame": _stale, "k1_state_unchanged": _k1_state_unchanged,
          "half_planes": _half_planes, "half_rows_mean": _half_rows_mean,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell", ["tiny.seg", "tiny.inr"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    result, _ = harness.run(cell, 2**31 + 77, 0.3, False, root=root,
                            device="cpu", log_fn=lambda m: None,
                            min_frames=12)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ["tiny.seg", "tiny.inr"])
def test_sound_run_comes_out_correct(root, cell):
    result, _ = harness.run(cell, 2**31 + 77, 0.3, False, root=root,
                            device="cpu", log_fn=lambda m: None,
                            min_frames=12)
    assert result["correct"] is True, result["checks"]
