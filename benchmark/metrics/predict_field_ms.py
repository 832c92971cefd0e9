"""Device ms a traced frame of the activities launched inside
``ops/neural_march.predict_field`` (the INR field: resample and MLP)."""


def read(t):
    acts = t.in_span("predict_field")
    return sum(a.dur for a in acts) * 1e-3 / t.n_frames if acts else None
