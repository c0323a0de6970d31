"""Percent of the traced stretch in which no operation ran on the device,
mean over the cards (device trace)."""
from portbench.readers import idle_share as read  # noqa: F401
