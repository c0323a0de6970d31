"""What every driver shares: the run's context, the program's pipeline
built from a cell's file, the clock, and the look for JAX in the process.

A driver's ``run(ctx)`` sets the program up, warms up the shapes its
traffic uses, measures for ``ctx.seconds``, and returns the facts the
metric readers and the comparison read (see ``run.py``)."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench import spec as spec_lib

#: top-level modules that must never be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    spec: Dict                     # the cell's file, config and mix loaded
    seed: int
    seconds: float
    trace: bool
    device: torch.device           # the card of a one-chip cell, or rank 0's
    t_start: float                 # clock() at the process's start
    model_cfg: object = None       # the program's DiTConfig

    @property
    def model(self) -> Dict:
        return self.spec["config_spec"]["model"]


def clock() -> float:
    """Seconds on the host's monotonic clock (one clock for every process
    of the machine)."""
    return time.perf_counter()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pipeline(ctx: Context, params, device):
    """The program's StadiPipeline on the cell's plan."""
    from repro_torch.core import sampler
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline

    plan, sched = ctx.spec["plan"], ctx.spec["config_spec"]["schedule"]
    config = StadiConfig.from_occupancies(
        plan["occupancies"], m_base=plan["m_base"], m_warmup=plan["m_warmup"],
        planner=plan["planner"], backend=plan["backend"],
        exchange=plan["exchange"])
    return StadiPipeline(ctx.model_cfg, params,
                         sampler.linear_schedule(sched["T"], sched["beta_min"],
                                                 sched["beta_max"]),
                         config, device=device)


def program_plan(pipe):
    """(steps a device, token rows a device) of the program's plan."""
    p = pipe.plan()
    return list(p.temporal.steps), list(p.patches)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are forbidden, compared
    whole (``repro_torch`` is not ``repro``)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def new_context(workload: str, seed: int, seconds: float, trace: bool,
                device, t_start: float,
                overrides: Optional[Dict] = None) -> Context:
    """A run's context; ``overrides`` replaces keys of the cell's file
    (``model`` merges into the configuration's model), as the tests do
    to run a cell at a small size on the CPU."""
    spec = spec_lib.workload(workload)
    for key, value in (overrides or {}).items():
        if key == "model":
            spec["config_spec"]["model"] = {**spec["config_spec"]["model"], **value}
        elif isinstance(value, dict) and isinstance(spec.get(key), dict):
            spec[key] = {**spec[key], **value}
        else:
            spec[key] = value
    ctx = Context(spec, int(seed), float(seconds), bool(trace),
                  torch.device(device), t_start)
    ctx.model_cfg = spec_lib.model_config(spec["config_spec"])
    return ctx
