"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a cell's file under ``workloads/``, its configuration under
``configs/``, its traffic mix under ``traffic/``, and a metric's reader
under ``metrics/``. A cell, a configuration, a mix or a metric is added by
adding its file and its entry, and no code here changes."""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(kind: str, name: str) -> Dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> Dict:
    """A cell's file, with its configuration and traffic mix loaded
    under ``config_spec`` and ``mix``."""
    spec = _load("workloads", name)
    spec["name"] = name
    spec["config_spec"] = _load("configs", spec["config"])
    spec["mix"] = _load("traffic", spec["traffic"])
    return spec


def metrics_of(cell: str, section: str) -> List[Dict]:
    """The entries of ``end_to_end`` or ``per_layer`` this cell reports: a
    metric without a ``workloads`` key is reported in every cell."""
    return [m for m in benchmark()[section]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The ``read(t)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def model_config(config_spec: Dict):
    """The program's DiTConfig of a configuration file's ``model``."""
    from repro_torch.configs.diffusion import DiTConfig

    return DiTConfig(**config_spec["model"])
