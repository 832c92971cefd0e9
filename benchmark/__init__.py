"""Benchmark of the PyTorch/CUDA port (``mri_raytracer_tpu_torch``).

One run renders one cell of ``BENCHMARK.json`` once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, span or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``systems/<system>.py``, ``spans/<span>.json``, ``e2e/<metric>.py`` and
``metrics/<metric>.py``. ``reference/`` holds the plain reference that
decides ``correct``; ``counts.py`` the operations, bytes and peaks the
rooflines and ``frame_mfu`` divide by; ``control.py`` the readings the
limits were set from.
"""
