"""K1 (``csrc/composite.cu``'s ``composite_kernel``, launched by
``ops/composite.composite_planes``) against its bound, in %."""

from benchmark.metrics._roofline import share


def read(t):
    return share(t, "composite_kernel", t.k1_bound_ms)
