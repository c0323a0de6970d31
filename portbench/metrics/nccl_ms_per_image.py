"""Milliseconds of NCCL kernels an image, mean over the ranks (device
trace)."""
from portbench.readers import nccl_ms_per_image as read  # noqa: F401
