"""Config registry of the port: ``get_config("<arch-id>")`` / ``--arch <id>``
for the models the port runs (reference: ``repro.configs``): the diffusion
models and the reference's ten assigned language models."""
from __future__ import annotations

import importlib
from typing import List, Union

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.diffusion import DiTConfig

DIFFUSION: List[str] = ["sdxl-dit", "tiny-dit"]
LANGUAGE: List[str] = ["xlstm-125m", "olmoe-1b-7b", "seamless-m4t-medium",
                       "yi-9b", "minitron-8b", "hymba-1.5b", "llama3-405b",
                       "gemma-2b", "deepseek-moe-16b", "internvl2-76b"]


def get_config(arch_id: str) -> Union[DiTConfig, ArchConfig]:
    if arch_id not in DIFFUSION + LANGUAGE:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{DIFFUSION + LANGUAGE}")
    modname = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{modname}").CONFIG


def list_archs() -> List[str]:
    return DIFFUSION + LANGUAGE
