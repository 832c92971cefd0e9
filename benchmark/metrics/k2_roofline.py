"""K2 (``csrc/warp.cu``'s ``warp_kernel``, launched by
``ops/warp.warp_screen``) against its bound, in %."""

from benchmark.metrics._roofline import share


def read(t):
    return share(t, "warp_kernel", t.k2_bound_ms)
