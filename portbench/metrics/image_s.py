"""Seconds an image: the window's seconds over the images completed in
it (host clock)."""


def read(t):
    return t["window_s"] / t["completed"] if t.get("completed") else None
