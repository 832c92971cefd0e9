"""Device ms a traced frame of the activities launched inside
``ops/neural_march.mlp_block``: the INR field's MLP (the first layer, the
tail and the argmax), each block of planes of ``predict_field``."""


def read(t):
    acts = t.in_span("predict_field_mlp")
    return sum(a.dur for a in acts) * 1e-3 / t.n_frames if acts else None
