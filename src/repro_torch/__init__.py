"""STADI on PyTorch and CUDA: the port of the JAX package ``repro`` to an
NVIDIA H100. It imports torch, numpy and the standard library, never jax
and never ``repro``; its tests hold it to the JAX package."""
