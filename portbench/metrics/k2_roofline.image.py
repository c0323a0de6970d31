"""Kernel K2's share of its roofline over the traced stretch, summed over
the ranks (device trace)."""
from portbench.readers import roofline


def read(t):
    return roofline(t, "k2")
