"""The plain float32 reference the benchmark decides ``correct`` by: the
DiT denoiser, the STADI schedule and the prompt tower, in plain PyTorch.
It imports nothing of the program."""
