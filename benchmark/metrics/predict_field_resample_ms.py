"""Device ms a traced frame of the activities launched inside
``ops/neural_march.resample_block``: the INR field's resample (the hat
matrices, the planes' slices and the two bf16 products), each block of
planes of ``predict_field``."""


def read(t):
    acts = t.in_span("predict_field_resample")
    return sum(a.dur for a in acts) * 1e-3 / t.n_frames if acts else None
