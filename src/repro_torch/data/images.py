"""Synthetic structured image dataset for the diffusion quality wing — a
numpy-only copy of ``repro.data.images`` (which imports no JAX, but the port
imports nothing of the JAX package). The same seed gives bitwise the same
batches as the reference.

Class-conditional images with real spatial structure (oriented Gaussian
blobs + class-dependent stripe frequency/phase on a shaded background), in
[-1, 1], ``[B, S, S, C]`` float32 with int32 class ids. A tiny DiT trained
on these gives a meaningful Table-II analogue (DESIGN.md §6).
"""
from __future__ import annotations

import numpy as np


class SyntheticImages:
    def __init__(self, size: int = 32, channels: int = 3, n_classes: int = 16,
                 seed: int = 0):
        self.size = size
        self.channels = channels
        self.n_classes = n_classes
        g = np.random.default_rng(seed)
        # per-class style parameters
        self.freq = g.uniform(1.0, 4.0, n_classes)
        self.angle = g.uniform(0, np.pi, n_classes)
        self.tint = g.uniform(-0.5, 0.5, (n_classes, channels))

    def sample(self, rng: np.random.Generator, batch: int):
        S, C = self.size, self.channels
        cls = rng.integers(0, self.n_classes, batch)
        yy, xx = np.mgrid[0:S, 0:S] / S
        imgs = np.empty((batch, S, S, C), np.float32)
        for i, c in enumerate(cls):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            sx, sy = rng.uniform(0.08, 0.2, 2)
            th = self.angle[c] + rng.normal(0, 0.15)
            u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
            blob = np.exp(-(u ** 2 / (2 * sx ** 2) + v ** 2 / (2 * sy ** 2)))
            stripes = 0.4 * np.sin(2 * np.pi * self.freq[c] * u * S / 8 + rng.uniform(0, 2 * np.pi))
            shade = 0.3 * (yy - 0.5)
            base = blob + stripes * blob + shade
            for ch in range(C):
                imgs[i, :, :, ch] = base + self.tint[c, ch]
        return np.clip(imgs, -1, 1), cls.astype(np.int32)

    def batches(self, batch: int, seed: int = 1):
        rng = np.random.default_rng(seed)
        while True:
            yield self.sample(rng, batch)
