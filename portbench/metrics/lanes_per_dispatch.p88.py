"""Request lanes a denoiser dispatch of the serving engine carried over
the window (the engine's own counters)."""
from portbench.readers import lanes_per_dispatch as read  # noqa: F401
