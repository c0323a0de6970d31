"""The port's benchmark: one run of one cell (``run.py``), the general
traffic generator, the drivers that put it to the program, the readers of
the per-layer metrics, and the plain reference that decides ``correct``."""
