"""Device ms a traced frame of the activities launched inside
``render/brats.present``: the copy of the frame's pixels to the host that
ends ``render_numpy``."""


def read(t):
    acts = t.in_span("present")
    return sum(a.dur for a in acts) * 1e-3 / t.n_frames if acts else None
