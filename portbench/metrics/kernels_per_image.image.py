"""Device operations an image in the traced stretch, mean over the ranks
(device trace)."""
from portbench.readers import kernels_per_image as read  # noqa: F401
