"""INR field points a second of the field's device time: the program's
counters ``field.points`` over ``frames`` (the mean a frame over every
frame the process rendered, the warm-up's three, the window's and the
traced part's; the traced frames sample the window evenly), over the
device seconds a traced frame of the activities launched inside
``ops/neural_march.predict_field``. None where the program keeps no such
counters."""


def read(t):
    try:
        from mri_raytracer_tpu_torch.utils import profiling

        c = profiling.counters()
    except (ImportError, AttributeError):
        return None
    acts = t.in_span("predict_field")
    if not (acts and c.get("field.points") and c.get("frames")):
        return None
    device_s = sum(a.dur for a in acts) * 1e-6 / t.n_frames
    return c["field.points"] / c["frames"] / device_s
