"""Share of the traced frames' time in the measured window in which the
device ran none of their work, in %: for each traced frame, the union of
the device activities it launched (the profiler's trace) against the time
the same frame took in the window (host clock, no profiler running). The
traced part's own gaps are left out: the profiler stretches the host's
side of a frame, not its device activities."""


def read(t):
    js = [j for j in range(t.n_frames) if j in t.window_frame_s]
    spent = sum(t.window_frame_s[j] for j in js)
    busy = sum(t.frame_busy_s(j) for j in js)
    return 100.0 * (1.0 - busy / spent) if spent and busy else None
