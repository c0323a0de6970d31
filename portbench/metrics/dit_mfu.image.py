"""The DiT forwards' share of the cards' bf16 peak over the traced stretch
(operations from the forwards' shapes, seconds from the device trace)."""
from portbench.readers import mfu as read  # noqa: F401
