"""Seconds from the start of the process to the opening of the window:
weights, the build or load of the kernels, warm-up (host clock)."""


def read(t):
    return t["setup_s"]
