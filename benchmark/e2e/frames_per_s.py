"""Frames presented in the window over the window's seconds."""


def read(w) -> float:
    return len(w.times) / (w.end - w.start)
