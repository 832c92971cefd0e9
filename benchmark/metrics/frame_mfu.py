"""The whole frame's share of the card's peaks: the least time of the
traced frames' nominal work (``counts.frame_work``: MLP FLOPs on the bf16
tensor cores, compositing on the fp32 units, bytes on device memory, the
largest of the three) over the time the same frames took in the measured
window, in %."""


def read(t):
    js = [j for j in t.least_s if j in t.window_frame_s]
    spent = sum(t.window_frame_s[j] for j in js)
    return 100.0 * sum(t.least_s[j] for j in js) / spent if spent else None
