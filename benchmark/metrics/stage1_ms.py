"""Device ms a traced frame of the activities launched inside
``ops/composite.stage1`` (plane table, b-axis bf16 resample, label rows)."""


def read(t):
    acts = t.in_span("stage1")
    return sum(a.dur for a in acts) * 1e-3 / t.n_frames if acts else None
