"""Denoisers and shared layers of the port."""
