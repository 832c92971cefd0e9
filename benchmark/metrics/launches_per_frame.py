"""Device activities (kernels, copies, sets) a traced frame: the host's
issue count, launched from inside the frames."""


def read(t):
    n = sum(1 for a in t.activities if a.frame is not None)
    return n / t.n_frames if n else None
