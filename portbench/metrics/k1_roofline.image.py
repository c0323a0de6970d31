"""Kernel K1's share of its roofline over the traced stretch (device trace)."""
from portbench.readers import roofline


def read(t):
    return roofline(t, "k1")
