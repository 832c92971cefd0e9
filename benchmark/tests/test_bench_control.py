"""The control: the reference put in the program's place, one step below
the precision the configuration states. At a small case it must come out
not correct, and the program correct (on the CPU; on the card too where
one is present). ``python3 -m benchmark.control`` reads the same at the
cells' own size on the card."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _readings(root, cell, device):
    return control.readings(cell, [2**31 + 3, 2**31 + 4], [2**31 + 5], 0.3,
                            root=root, device=device, log_fn=lambda m: None)


def _check(rows, cell):
    assert all(r["correct"] for r in rows if r["run"] == "program"), rows
    controls = [r for r in rows if r["run"] != "program"]
    want = {"control:resample_fp8", "control:composite_bf16"} | (
        {"control:mlp_fp8"} if cell == "tiny.inr" else set())
    assert {r["run"] for r in controls} == want
    assert not any(r["correct"] for r in controls), controls


@pytest.mark.parametrize("cell", ["tiny.seg", "tiny.inr"])
def test_controls_fail_and_the_program_passes(root, cell):
    _check(_readings(root, cell, "cpu"), cell)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.seg", "tiny.inr"])
def test_controls_fail_and_the_program_passes_on_the_card(root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels K1 and K2)")
    _check(_readings(root, cell, "cuda"), cell)
