"""A kernel's share of its roofline over the sampled traced frames: the sum
of the frozen bounds (``counts.k1_cost`` / ``k2_cost`` on the reference's
counts of those frames' work) over the sum of the kernel's device time in
the same frames, in %."""


def share(t, kernel: str, bounds_ms):
    bound = spent = 0.0
    for j, b in bounds_ms.items():
        us = sum(a.dur for a in t.activities
                 if a.frame == j and kernel in a.name)
        if us > 0.0:
            bound += b
            spent += us * 1e-3
    return 100.0 * bound / spent if spent else None
