"""End-to-end diffusion training on the port (reference:
``examples/train_tiny_diffusion.py``).

Trains the tiny class-conditional DiT denoiser on the synthetic structured
image dataset and checkpoints it in the reference's format (either package
restores it): ``repro_torch.launch.train_tiny_diffusion``, which runs on the
GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/train_tiny_diffusion_torch.py --steps 400
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train_tiny_diffusion import main

if __name__ == "__main__":
    main()
