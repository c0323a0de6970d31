"""Config registry of the port: ``get_config("<arch-id>")`` / ``--arch <id>``
for the models the port runs (reference: ``repro.configs``): the diffusion
models and, of the reference's assigned language models, the dense, MoE,
VLM and hybrid decoders."""
from __future__ import annotations

import importlib
from typing import List, Union

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.diffusion import DiTConfig

DIFFUSION: List[str] = ["sdxl-dit", "tiny-dit"]
LANGUAGE: List[str] = ["olmoe-1b-7b", "yi-9b", "minitron-8b", "hymba-1.5b",
                       "llama3-405b", "gemma-2b", "deepseek-moe-16b",
                       "internvl2-76b"]
#: the reference's other assigned language models, which a later slice brings
LATER: List[str] = ["xlstm-125m", "seamless-m4t-medium"]


def get_config(arch_id: str) -> Union[DiTConfig, ArchConfig]:
    if arch_id in LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet: it comes with "
                       "ROADMAP.md queue 1 item 15c (the xLSTM and enc-dec LMs)")
    if arch_id not in DIFFUSION + LANGUAGE:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{DIFFUSION + LANGUAGE}")
    modname = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{modname}").CONFIG


def list_archs() -> List[str]:
    return DIFFUSION + LANGUAGE
