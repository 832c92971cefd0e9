"""The 95th percentile (nearest rank) of all the window's frame times, each
from its call to its pixels on the host, in ms."""

import math


def read(w) -> float:
    ms = sorted((t1 - t0) * 1e3 for t0, t1 in w.times)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
