"""STADI: Spatio-Temporal Adaptive Diffusion Inference (Algorithm 1) — the
port of ``repro.core.stadi``.

DEPRECATED module-level entry point. The supported API is

    from repro_torch.core.pipeline import StadiConfig, StadiPipeline
    pipe = StadiPipeline(cfg, params, sched, StadiConfig(cluster, ...))
    result = pipe.generate(x_T, cond)

``stadi_infer`` remains as a thin shim mapping the old (temporal, spatial)
ablation flags onto the planner registry (DESIGN.md §8 migration table):
(False, False) -> "uniform", (False, True) -> "spatial",
(True, False) -> "temporal", (True, True) -> "stadi".
"""
from __future__ import annotations

import warnings
from typing import Sequence

from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core.patch_parallel import RunResult
from repro_torch.core.sampler import NoiseSchedule

_PLANNER_BY_FLAGS = {(False, False): "uniform", (False, True): "spatial",
                     (True, False): "temporal", (True, True): "stadi"}


def stadi_infer(params, cfg: DiTConfig, sched: NoiseSchedule, x_T, cond,
                speeds: Sequence[float], m_base: int, m_warmup: int,
                a: float = 0.75, b: float = 0.25,
                granularity: int = 1,
                temporal: bool = True, spatial: bool = True,
                tiers: Sequence[int] = (1, 2), device=None) -> RunResult:
    """Deprecated: use StadiPipeline. Full STADI (temporal=spatial=True);
    ablations by flipping the flags (paper Table III). ``device`` is where
    the numerics run (``cuda`` unless given), as in ``StadiPipeline``."""
    warnings.warn("stadi_infer() is deprecated; use "
                  "repro_torch.core.pipeline.StadiPipeline.generate()",
                  DeprecationWarning, stacklevel=2)
    from repro_torch.core import hetero
    from repro_torch.core.pipeline import StadiConfig, StadiPipeline

    cluster = tuple(hetero.DeviceProfile(f"dev{i}", c=v)
                    for i, v in enumerate(speeds))
    config = StadiConfig(cluster=cluster, m_base=m_base, m_warmup=m_warmup,
                         a=a, b=b, tiers=tuple(tiers),
                         granularity=granularity,
                         planner=_PLANNER_BY_FLAGS[(temporal, spatial)],
                         backend="emulated")
    res = StadiPipeline(cfg, params, sched, config,
                        device=device).generate(x_T, cond)
    return RunResult(res.image, res.trace)
