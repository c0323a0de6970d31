"""Diffusion denoisers of the port."""
