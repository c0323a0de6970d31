"""Config registry of the port: ``get_config("<arch-id>")`` / ``--arch <id>``
for the diffusion models this slice runs (reference: ``repro.configs``)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.diffusion import DiTConfig

DIFFUSION: List[str] = ["sdxl-dit", "tiny-dit"]


def get_config(arch_id: str) -> DiTConfig:
    if arch_id not in DIFFUSION:
        raise KeyError(f"unknown arch {arch_id!r}; the port has {DIFFUSION}")
    return importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_')}").CONFIG


def list_archs() -> List[str]:
    return list(DIFFUSION)
