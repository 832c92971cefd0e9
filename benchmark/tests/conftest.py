"""The harness samples fewer frames in the tiny cells' runs, to keep the
CPU tests short."""

import pytest

from benchmark import harness


@pytest.fixture(autouse=True)
def _small_sampling(monkeypatch):
    monkeypatch.setattr(harness, "CHECK_FRAMES", 3)
    monkeypatch.setattr(harness, "TRACE_FRAMES", 4)
    monkeypatch.setattr(harness, "ROOFLINE_EVERY", 2)
