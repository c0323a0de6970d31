"""Unified STADI pipeline of the port: one config object, pluggable planners
and execution backends (reference: ``repro.core.pipeline``, DESIGN.md §8).

    cfg    = get_config("tiny-dit").reduced()
    params = dit.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    sched  = sampler.linear_schedule(T=1000)
    config = StadiConfig.from_occupancies([0.0, 0.6], m_base=16, m_warmup=4)
    pipe   = StadiPipeline(cfg, params, sched, config)       # on "cuda"
    result = pipe.generate(x_T, cond)          # result.image, result.trace

Backends registered in the port:

    "emulated"  exact-numerics logical-worker engine (patch_parallel) — the
                heterogeneous workers are logical workers on one device
    "spmd"      one torch.distributed rank per worker (core/spmd.run_spmd),
                unguided or fused guidance
    "spmd_guidance"  split guidance on 2 * n_pairs ranks, the cond/uncond
                branch groups (core/spmd.run_spmd_guidance)
    "spmd_seq"  sequence-parallel attention on seq_shards * n_workers ranks
                (core/spmd.run_spmd_seq)
    "pipefuse"  the displaced stage chain, emulated (core/pipefuse.
                run_pipefuse; bitwise "emulated" at one stage)
    "spmd_pipefuse"  the stage chain on one rank per stage
                (core/spmd.run_spmd_pipefuse)
    "spmd_frames"  the frame axis on n_groups x n_workers ranks
                (core/spmd.run_spmd_frames)
    "simulate"  trace-only latency modeling (no numerics; needs a CostModel)

The multi-rank backends run inside the ranks of an initialized process
group (:mod:`repro_torch.launch.ranks` starts them): every rank calls
``generate`` with the same inputs, on its own device, and gets the full
image back.

``cfg_scale > 0`` makes every generation guided (classifier-free guidance,
DESIGN.md §12): plain planners get the fused placement, and the
``stadi_guidance`` planner searches fused vs split (or runs the placement
``guidance`` pins: fused, split or interleaved). ``seq_shards > 1`` (or the
``stadi_seq`` planner) shards every attention over sequence shards
(DESIGN.md §13): the emulated backend runs its numerics, ``spmd_seq`` its
ranks. ``num_stages > 1`` (or the ``stadi_pipefuse`` planner) splits the
DiT depth into a stage chain (DESIGN.md §11) that the ``pipefuse`` and
``spmd_pipefuse`` backends run. ``num_frames > 1`` generates a video
(DESIGN.md §16) from a ``[B, F, H, W, C]`` latent: frame-sequential for plain
planners, or the frame placement the ``stadi_video`` planner searches
(``frame_groups`` pins it); the emulated backend runs it in one process
(:func:`repro_torch.core.frames.run_frames`), ``spmd_frames`` on ranks.

The pipeline runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request it raises. On the card every
attention runs the hand-written CUDA kernel; ``PipelineResult.kernel_stats``
reports how many times each kernel was launched during the call (the
reference reports trace-time kernel hits and misses instead).

``rebalance_every=k`` turns on online rebalancing (emulated backend): every k
adaptive intervals the per-device interval latencies — synthesized from the
cost model at ``measured_speeds`` — feed a
:class:`repro_torch.core.hetero.OnlineProfiler`; when its speed estimate
drifts past ``rebalance_threshold`` the remaining fine steps are re-planned.

With ``plan_cache_dir`` set, ``plan()`` consults a persistent
:class:`~repro_torch.serving.plan_cache.PlanCache` before any planner
search, under the reference's key recipe (an entry either package wrote is
a hit in the other). ``generate_many`` serves many requests through the
continuous-batching :class:`~repro_torch.serving.diffusion_engine.
DiffusionServingEngine`, whose lanes come from the stepper factories
registered here (:func:`register_stepper_factory`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import warnings
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import torch

from repro_torch import spans
from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core import frames as frames_lib
from repro_torch.core import hetero
from repro_torch.core import patch_parallel as pp
from repro_torch.core import simulate as sim
from repro_torch.core.comm import get_exchange
from repro_torch.core.events import ExecutionTrace
from repro_torch.core.guidance import GUIDANCE_MODES, GuidancePlan
from repro_torch.core.hetero import DeviceProfile
from repro_torch.core.planners import ExecutionPlan, get_planner
from repro_torch.core.sampler import NoiseSchedule
from repro_torch.core.simulate import CostModel
from repro_torch.kernels import ops as kops

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or implied) and absent — never
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless "
                           "the caller passes device='cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class StadiConfig:
    """Everything STADI needs to know that is not the model or the input."""
    cluster: Tuple[DeviceProfile, ...]
    # schedule knobs (paper §IV, Eq. 4 / Eq. 5)
    m_base: int = 16
    m_warmup: int = 4
    a: float = 0.75
    b: float = 0.25
    tiers: Tuple[int, ...] = (1, 2)
    granularity: int = 1
    min_patch: Optional[int] = None
    # strategy selection
    planner: str = "stadi"
    backend: str = "emulated"
    # boundary-exchange policy (DESIGN.md §10): "sync" | "stale_async" |
    # "predictive"; exchange_refresh = E => one corrective full refresh
    # every E interval boundaries (ignored by "sync")
    exchange: str = "sync"
    exchange_refresh: int = 2
    # classifier-free guidance (DESIGN.md §12): cfg_scale > 0 turns every
    # generation into a guided one (eps = eps_u + w*(eps_c - eps_u));
    # guidance picks the placement — "none" means fused for plain planners,
    # or lets the stadi_guidance planner search; "split"/"interleaved" need
    # planner="stadi_guidance". uncond_refresh is the interleaved reuse
    # cadence. latent_bytes / kv_row_bytes are byte provenance for the
    # guided planner's cost model; StadiPipeline fills them in (leave 0).
    guidance: str = "none"
    cfg_scale: float = 0.0
    uncond_refresh: int = 2
    latent_bytes: int = 0
    kv_row_bytes: int = 0
    # sequence-parallel attention (DESIGN.md §13): Ulysses/ring shards of
    # every patch worker's attention (1 = unsharded; 0 = let the stadi_seq
    # planner search). n_heads is the head count the seq planner scatters;
    # StadiPipeline fills it in from the model config (leave None).
    seq_shards: int = 1
    n_heads: Optional[int] = None
    # displaced stage chain (DESIGN.md §11): depth stages the DiT block
    # stack is split into (1 = none; 0 = let the stadi_pipefuse planner
    # search); micro_patches pins the micro-batch count (0 = auto); depth is
    # the DiT block count, which StadiPipeline fills in (leave None)
    num_stages: int = 1
    micro_patches: int = 0
    depth: Optional[int] = None
    # video (DESIGN.md §16): latent frames denoised jointly (1 = image);
    # frame_groups picks the placement: 1 = frame-sequential, > 1 =
    # frame-parallel member rows (planner='stadi_video'), 0 = let the
    # stadi_video planner search
    num_frames: int = 1
    frame_groups: int = 0
    # prompt conditioning (DESIGN.md §17): the prompt-token bucket the
    # planner prices (CostModel.t_xattn per token read). 0 = derive from the
    # model config (cond_seq_len when cross_attn, else no cross-attention
    # cost); a serving bucket pins a shorter one
    cond_bucket: int = 0
    # persistent plan cache (DESIGN.md §14): directory for serialized
    # planner outputs keyed by (cluster signature, model hash, workload
    # shape). None = no cache; StadiPipeline.plan() consults it before any
    # planner search and OnlineProfiler drift invalidates stale entries.
    plan_cache_dir: Optional[str] = None
    # latency modeling ("simulate" backend; also latency reporting elsewhere)
    cost_model: Optional[CostModel] = None
    # online rebalancing (beyond-paper, DESIGN.md §7.1)
    rebalance_every: int = 0             # adaptive intervals between checks; 0 = off
    rebalance_threshold: float = 0.2     # max relative speed drift tolerated
    profiler_alpha: float = 0.5          # EWMA weight for OnlineProfiler

    @classmethod
    def from_occupancies(cls, occupancies: Sequence[float],
                         capabilities: Optional[Sequence[float]] = None,
                         **knobs) -> "StadiConfig":
        """Paper's experimental grid: homogeneous GPUs + per-device occupancy."""
        cluster = tuple(hetero.make_cluster(occupancies, capabilities))
        return cls(cluster=cluster, **knobs)

    @property
    def speeds(self) -> List[float]:
        return [d.v for d in self.cluster]

    @property
    def n_devices(self) -> int:
        return len(self.cluster)


@dataclasses.dataclass
class ReplanEvent:
    """One online re-allocation (fine-step granularity provenance)."""
    fine_step: int
    drift: float
    speeds_before: List[float]
    speeds_after: List[float]
    plan: ExecutionPlan


@dataclasses.dataclass
class PipelineResult:
    """What ``StadiPipeline.generate`` returns, for every backend.

    image is None for the trace-only "simulate" backend; latency_s is None
    unless a cost model was configured. kernel_stats is
    ``{"launches": {kernel: n}}``: CUDA kernel launches during this call
    (empty on the CPU, where every wrapper runs its plain version).
    """
    image: Optional[torch.Tensor]
    trace: ExecutionTrace
    plan: ExecutionPlan
    latency_s: Optional[float] = None
    replans: List[ReplanEvent] = dataclasses.field(default_factory=list)
    kernel_stats: Dict = dataclasses.field(default_factory=dict)


class Executor(Protocol):
    """A backend: executes an ExecutionPlan, returns (image | None, trace)."""

    def __call__(self, params, model_cfg: DiTConfig, sched: NoiseSchedule,
                 x_T, cond, plan: ExecutionPlan, config: StadiConfig,
                 interval_hook=None) -> Tuple[Optional[torch.Tensor], ExecutionTrace]:
        ...


# ----------------------------------------------------------------------
# executor registry: declarative backend capabilities (DESIGN.md §14)
# ----------------------------------------------------------------------

#: the ONE normalized executor call signature
EXECUTOR_KWARGS = ("params", "model_cfg", "sched", "x_T", "cond", "plan",
                   "config", "interval_hook")

#: every feature token a plan can demand from a backend
PLAN_FEATURES = ("stages", "guidance.fused", "guidance.split",
                 "guidance.interleaved", "seq", "seq.uneven", "frames")

#: valid ``requires=`` tokens besides PLAN_FEATURES: a bare axis prefix
#: ("guidance") satisfied by any mode of that axis
_REQUIRE_PREFIXES = ("guidance", "seq", "stages", "frames")


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered executor plus the plan features it can execute
    (``supports``) and those it needs a plan to demand (``requires``)."""
    fn: Executor
    supports: frozenset
    requires: frozenset


EXECUTORS: Dict[str, BackendSpec] = {}


def register_executor(name: str, *, supports: Sequence[str] = (),
                      requires: Sequence[str] = ()
                      ) -> Callable[[Executor], Executor]:
    supports_f, requires_f = frozenset(supports), frozenset(requires)
    bad = ((supports_f - set(PLAN_FEATURES))
           | (requires_f - set(PLAN_FEATURES) - set(_REQUIRE_PREFIXES)))
    if bad:
        raise ValueError(f"executor {name!r} declares unknown capability "
                         f"tokens {sorted(bad)}; known: {PLAN_FEATURES}")

    def deco(fn: Executor) -> Executor:
        sig = tuple(inspect.signature(fn).parameters)
        if sig != EXECUTOR_KWARGS:
            raise TypeError(f"executor {name!r} must accept exactly the "
                            f"normalized kwargs {EXECUTOR_KWARGS}, got {sig}")
        EXECUTORS[name] = BackendSpec(fn, supports_f, requires_f)
        return fn
    return deco


def get_executor_spec(name: str) -> BackendSpec:
    try:
        return EXECUTORS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{sorted(EXECUTORS)}") from None


def get_executor(name: str) -> Executor:
    return get_executor_spec(name).fn


def backends_supporting(feature: str) -> Tuple[str, ...]:
    """Registered backends that can execute ``feature`` (an exact token, or
    a bare axis prefix such as "guidance" matching any of its modes)."""
    return tuple(name for name, spec in EXECUTORS.items()
                 if any(f == feature or f.startswith(feature + ".")
                        for f in spec.supports))


def required_features(plan: ExecutionPlan, config=None) -> List[str]:
    """Feature tokens a plan (and the config's ``seq_shards`` and
    ``num_frames``) demands of a backend, in the check order (stages,
    guidance, seq, frames)."""
    feats: List[str] = []
    if plan.stages is not None and len(plan.stages) > 1:
        feats.append("stages")
    if plan.guidance is not None:
        feats.append("guidance." + plan.guidance.mode)
    planned_seq = plan.seq is not None and len(plan.seq.segments) > 1
    if planned_seq or (config is not None and config.seq_shards > 1):
        feats.append("seq")
        if planned_seq and not plan.seq.even_heads():
            feats.append("seq.uneven")
    if ((plan.frames is not None and plan.frames.num_frames > 1)
            or (config is not None and config.num_frames > 1)):
        feats.append("frames")
    return feats


#: per-(backend, feature) rejection messages more specific than the
#: generic capability complaint (the reference's own table)
_BACKEND_FEATURE_ERRORS: Dict[Tuple[str, str], str] = {
    ("spmd", "guidance.split"):
        "{mode!r} guidance on SPMD needs the guidance mesh axis: use "
        "backend='spmd_guidance'",
    ("spmd", "guidance.interleaved"):
        "{mode!r} guidance on SPMD needs the guidance mesh axis: use "
        "backend='spmd_guidance'",
    ("spmd_guidance", "guidance.fused"):
        "backend 'spmd_guidance' runs the split guidance mesh; fused CFG "
        "runs on the plain 'spmd' backend",
    ("spmd_guidance", "guidance.interleaved"):
        "interleaved uncond reuse is not implemented on SPMD; use the "
        "'emulated' or 'pipefuse' backend",
    ("spmd_seq", "seq.uneven"):
        "spmd_seq needs an even head scatter for the all-to-all (got "
        "{heads}); speed-proportional uneven heads are the cost model's "
        "planning view — run uneven plans on the 'emulated' backend, or "
        "pin seq_shards to a divisor of n_heads",
}

#: messages for a backend whose ``requires`` declaration is unmet
_BACKEND_REQUIRES_ERRORS: Dict[Tuple[str, str], str] = {
    ("spmd_guidance", "guidance"):
        "backend 'spmd_guidance' needs a guided plan: set cfg_scale > 0 "
        "with planner='stadi_guidance' and guidance='split'",
    ("spmd_seq", "seq"):
        "backend 'spmd_seq' runs the sequence mesh and needs a "
        "seq-sharded plan: set seq_shards > 1, or planner='stadi_seq' "
        "with seq_shards=0 (auto); an attention-unsharded plan runs on "
        "the plain 'spmd' backend",
    ("spmd_frames", "frames"):
        "backend 'spmd_frames' runs the frame mesh and needs a "
        "multi-frame plan: set num_frames > 1 (optionally "
        "planner='stadi_video' for the frame-parallel placement); a "
        "single-frame plan runs on the plain 'spmd' backend",
}


def _reject_message(backend: str, feature: str, plan: ExecutionPlan) -> str:
    """The reference's rejection text for a feature a backend lacks."""
    override = _BACKEND_FEATURE_ERRORS.get((backend, feature))
    if override is not None:
        return override.format(
            mode=getattr(plan.guidance, "mode", None),
            heads=list(plan.seq.heads) if plan.seq is not None else None)
    if feature.startswith("guidance."):
        return (f"guided generation (cfg_scale={plan.guidance.scale}) needs a "
                f"guided backend ({list(backends_supporting('guidance'))}), "
                f"not {backend!r}")
    if feature == "seq":
        return (f"a sequence-sharded plan (seq_shards > 1) needs a seq "
                f"backend ({list(backends_supporting('seq'))}), not "
                f"{backend!r}; pin seq_shards=1 to force attention-"
                "unsharded execution")
    if feature == "frames":
        return (f"a multi-frame plan (num_frames > 1) needs a frame "
                f"backend ({list(backends_supporting('frames'))}), not "
                f"{backend!r}; pin num_frames=1 for the image path")
    return f"{backend!r} does not support the planned {feature!r}"


# ----------------------------------------------------------------------
# serving hooks: round-granular steppers for continuous batching
# ----------------------------------------------------------------------
#
# An Executor runs one whole generation; the diffusion serving engine
# (repro_torch.serving.diffusion_engine) instead drives MANY in-flight
# requests one scheduling round at a time, so each backend that supports
# serving also registers a *stepper factory*: ``factory(pipeline, plan,
# slots) -> Stepper`` where a Stepper exposes
#
#     warmup_step(xs, t_from, t_to, conds) -> (xs', k, v)
#     interval(xs, fine0, conds, pub_k, pub_v, merge) -> (xs', pub_k', pub_v')
#     supports_guidance: bool   # + the *_guided forms of both
#
# over lane-stacked state (the lanes folded into the batch axis). The
# "emulated" stepper batches the denoiser over lanes so lanes at different
# noise-schedule positions share one dispatch; the "pipefuse" stepper adds
# the lanes' displaced stage contexts (``interval_ctx``), and the "spmd"
# stepper runs a cohort of lanes at one fine step across the ranks.

STEPPER_FACTORIES: Dict[str, Callable] = {}


def register_stepper_factory(name: str) -> Callable:
    def deco(fn):
        STEPPER_FACTORIES[name] = fn
        return fn
    return deco


def get_stepper_factory(name: str):
    try:
        return STEPPER_FACTORIES[name]
    except KeyError:
        raise KeyError(
            f"backend {name!r} has no serving stepper; registered: "
            f"{sorted(STEPPER_FACTORIES)} (the 'simulate' backend has no "
            "numerics to serve)") from None


def check_backend_can_run(plan: ExecutionPlan, config: StadiConfig) -> None:
    """Reject plan/backend mismatches from the capability declarations:
    every demanded feature must be in the backend's ``supports``; every
    ``requires`` token must be demanded by the plan (a feature family such
    as "guidance" is met by any of its members)."""
    spec = get_executor_spec(config.backend)
    feats = required_features(plan, config)
    for f in feats:
        if f not in spec.supports:
            raise ValueError(_reject_message(config.backend, f, plan))
    for req in spec.requires:
        if not any(f == req or f.startswith(req + ".") for f in feats):
            raise ValueError(
                _BACKEND_REQUIRES_ERRORS.get((config.backend, req))
                or f"backend {config.backend!r} requires a plan demanding "
                f"{req!r}")


_GUIDANCE_FEATURES = ("guidance.fused", "guidance.split",
                      "guidance.interleaved")


@register_executor("emulated",
                   supports=_GUIDANCE_FEATURES + ("seq", "seq.uneven",
                                                  "frames"))
def emulated_executor(params, model_cfg, sched, x_T, cond, plan, config,
                      interval_hook=None):
    if plan.frames is not None and plan.frames.num_frames > 1:
        # fused CFG composes with frames; split/interleaved guidance and
        # seq sharding are refused when the pipeline is built
        res = frames_lib.run_frames(params, model_cfg, sched, x_T, cond,
                                    plan.temporal, plan.patches,
                                    interval_hook=interval_hook,
                                    exchange=config.exchange,
                                    exchange_refresh=config.exchange_refresh,
                                    frames=plan.frames,
                                    guidance=plan.guidance)
        return res.image, res.trace
    res = pp.run_schedule(params, model_cfg, sched, x_T, cond,
                          plan.temporal, plan.patches,
                          interval_hook=interval_hook,
                          exchange=config.exchange,
                          exchange_refresh=config.exchange_refresh,
                          guidance=plan.guidance, seq=plan.seq)
    return res.image, res.trace


@register_executor("spmd", supports=("guidance.fused",))
def spmd_executor(params, model_cfg, sched, x_T, cond, plan, config,
                  interval_hook=None):
    # interval_hook is never passed here: generate() rejects rebalancing on
    # every backend but the emulated one
    from repro_torch.core import spmd
    img = spmd.run_spmd(params, model_cfg, sched, x_T, cond, plan.temporal,
                        plan.patches, exchange=config.exchange,
                        exchange_refresh=config.exchange_refresh,
                        guidance=plan.guidance)
    return img, _spmd_trace(model_cfg, x_T, plan, config)


@register_executor("spmd_guidance", supports=("guidance.split",),
                   requires=("guidance",))
def spmd_guidance_executor(params, model_cfg, sched, x_T, cond, plan, config,
                           interval_hook=None):
    """Split CFG over the cond/uncond branch groups of 2 * n_pairs ranks."""
    from repro_torch.core import spmd
    img = spmd.run_spmd_guidance(params, model_cfg, sched, x_T, cond,
                                 plan.temporal, plan.patches, plan.guidance,
                                 exchange=config.exchange,
                                 exchange_refresh=config.exchange_refresh)
    return img, _spmd_trace(model_cfg, x_T, plan, config)


def _spmd_trace(model_cfg, x_T, plan, config, stages=None) -> ExecutionTrace:
    """The multi-rank executors' trace: replayed from the plan, as the
    reference builds it (their numerics follow the same event stream)."""
    return sim.build_trace(plan.temporal, plan.patches, model_cfg,
                           batch=int(x_T.shape[0]), exchange=config.exchange,
                           exchange_refresh=config.exchange_refresh,
                           stages=stages, guidance=plan.guidance,
                           seq=plan.seq, frames=plan.frames)


@register_executor("simulate", supports=("stages",) + _GUIDANCE_FEATURES
                   + ("seq", "seq.uneven", "frames"))
def simulate_executor(params, model_cfg, sched, x_T, cond, plan, config,
                      interval_hook=None):
    batch = int(x_T.shape[0]) if x_T is not None else 1
    trace = sim.build_trace(plan.temporal, plan.patches, model_cfg,
                            batch=batch, exchange=config.exchange,
                            exchange_refresh=config.exchange_refresh,
                            stages=plan.stages, guidance=plan.guidance,
                            seq=plan.seq, frames=plan.frames,
                            cond_tokens=(config.cond_bucket or None))
    return None, trace


@register_executor("spmd_seq", supports=("seq",), requires=("seq",))
def spmd_seq_executor(params, model_cfg, sched, x_T, cond, plan, config,
                      interval_hook=None):
    """Sequence-parallel attention on seq_shards * n_workers ranks: each
    patch worker's seq group scatters heads and hops ring segments."""
    from repro_torch.core import spmd
    if plan.seq is None:
        raise ValueError(_BACKEND_REQUIRES_ERRORS[("spmd_seq", "seq")])
    if plan.guidance is not None:
        raise ValueError("guided generation is not implemented on the "
                         "'spmd_seq' backend; the 'emulated' backend runs "
                         "seq x CFG numerics")
    img = spmd.run_spmd_seq(params, model_cfg, sched, x_T, cond,
                            plan.temporal, plan.patches, plan.seq,
                            exchange=config.exchange,
                            exchange_refresh=config.exchange_refresh)
    return img, _spmd_trace(model_cfg, x_T, plan, config)


@register_executor("pipefuse", supports=("stages",) + _GUIDANCE_FEATURES)
def pipefuse_executor(params, model_cfg, sched, x_T, cond, plan, config,
                      interval_hook=None):
    """The displaced stage chain, emulated: bitwise "emulated" at one
    stage."""
    from repro_torch.core import pipefuse
    res = pipefuse.run_pipefuse(params, model_cfg, sched, x_T, cond,
                                plan.temporal, plan.patches,
                                plan.stages or [model_cfg.n_layers],
                                exchange=config.exchange,
                                exchange_refresh=config.exchange_refresh,
                                interval_hook=interval_hook,
                                guidance=plan.guidance)
    return res.image, res.trace


@register_executor("spmd_pipefuse", supports=("stages",))
def spmd_pipefuse_executor(params, model_cfg, sched, x_T, cond, plan, config,
                           interval_hook=None):
    """The stage chain on one rank per stage (ranks = stages)."""
    from repro_torch.core import spmd
    stages = plan.stages or [model_cfg.n_layers]
    img = spmd.run_spmd_pipefuse(params, model_cfg, sched, x_T, cond,
                                 plan.temporal, plan.patches, stages,
                                 exchange=config.exchange,
                                 exchange_refresh=config.exchange_refresh)
    return img, _spmd_trace(model_cfg, x_T, plan, config, stages=stages)


@register_executor("spmd_frames", supports=("frames",), requires=("frames",))
def spmd_frames_executor(params, model_cfg, sched, x_T, cond, plan, config,
                         interval_hook=None):
    """The frame axis on n_groups x n_workers ranks: member rows own frame
    chunks, patch-worker columns share each row's frames."""
    from repro_torch.core import spmd
    if plan.frames is None or plan.frames.num_frames <= 1:
        raise ValueError(_BACKEND_REQUIRES_ERRORS[("spmd_frames", "frames")])
    img = spmd.run_spmd_frames(params, model_cfg, sched, x_T, cond,
                               plan.temporal, plan.patches, plan.frames,
                               exchange=config.exchange,
                               exchange_refresh=config.exchange_refresh)
    return img, _spmd_trace(model_cfg, x_T, plan, config)


#: backends that can execute a depth-partitioned (staged) plan
STAGED_BACKENDS = backends_supporting("stages")

#: backends that can execute a sequence-sharded plan (DESIGN.md §13)
SEQ_BACKENDS = backends_supporting("seq")

#: backends that can execute a multi-frame (video) plan (DESIGN.md §16)
FRAME_BACKENDS = backends_supporting("frames")


def _resolve_stages(plan: ExecutionPlan, model_cfg, config: StadiConfig
                    ) -> Optional[List[int]]:
    """The stage split a staged executor runs: the plan's own (from the
    stadi_pipefuse planner) or, for plain planners, a speed-proportional
    split of ``config.num_stages`` (the --num-stages wiring)."""
    if plan.stages is not None:
        return list(plan.stages)
    if config.num_stages <= 1:
        return None
    if config.num_stages > config.n_devices:
        raise ValueError(
            f"num_stages={config.num_stages} is infeasible: the chain needs "
            f"one device per stage and the cluster has {config.n_devices} "
            "(the stadi_pipefuse planner rejects this identically)")
    chain = sim.chain_speeds(config.speeds, config.num_stages)
    return hetero.stage_partition(model_cfg.n_layers, chain)


def _resolve_seq(plan: ExecutionPlan, model_cfg, config: StadiConfig):
    """The SeqPlan an executor runs: the plan's own (from the stadi_seq
    planner) or, for plain planners with ``seq_shards > 1``, the uniform
    shards of the ``--seq-shards`` wiring. None = attention-unsharded."""
    if plan.seq is not None and len(plan.seq.segments) > 1:
        return plan.seq
    S = config.seq_shards
    if S in (0, 1):
        return None
    from repro_torch.core import seqpar
    if S > config.n_devices:
        raise ValueError(
            f"seq_shards={S} is infeasible: every patch-worker group needs "
            f"one device per sequence shard and the cluster has "
            f"{config.n_devices} (the stadi_seq planner rejects this "
            "identically)")
    if model_cfg.n_heads < S:
        raise ValueError(
            f"seq_shards={S} cannot scatter {model_cfg.n_heads} attention "
            "heads (Ulysses needs >= 1 head per shard)")
    return seqpar.make_seq_plan(model_cfg.n_heads, model_cfg.tokens_per_side,
                                S)


def _resolve_frames(plan: ExecutionPlan, config: StadiConfig):
    """The FramePlan an executor runs: the plan's own (from the stadi_video
    planner) or, for plain planners with ``num_frames > 1``, the
    frame-sequential placement (every patch worker evaluates all frames).
    None = the image path."""
    if plan.frames is not None and plan.frames.num_frames > 1:
        return plan.frames
    F = config.num_frames
    if F <= 1:
        return None
    if config.frame_groups > 1:
        raise ValueError(
            f"frame_groups={config.frame_groups} places frame chunks on "
            "device member rows — plan it with planner='stadi_video' "
            f"(planner {config.planner!r} allocates per-device workers)")
    return frames_lib.FramePlan(F, (F,))


def _resolve_guidance(plan: ExecutionPlan, config: StadiConfig):
    """The GuidancePlan an executor runs: the plan's own (from the
    stadi_guidance planner) or, for plain planners with ``cfg_scale`` set,
    the fused placement. None = unguided."""
    if plan.guidance is not None:
        return plan.guidance
    if config.cfg_scale <= 0.0 and config.guidance == "none":
        return None
    if config.guidance in ("split", "interleaved"):
        raise ValueError(
            f"guidance={config.guidance!r} placement pairs devices across "
            "branch groups — plan it with planner='stadi_guidance' "
            f"(planner {config.planner!r} allocates per-device workers)")
    if config.cfg_scale <= 0.0:
        raise ValueError(f"guidance={config.guidance!r} needs cfg_scale > 0")
    return GuidancePlan("fused", config.cfg_scale)


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; {new}", DeprecationWarning,
                  stacklevel=3)


def plan_stages(plan: ExecutionPlan, model_cfg, config: StadiConfig
                ) -> Optional[List[int]]:
    """Deprecated: ``StadiPipeline.plan()`` populates ``plan.stages``."""
    _deprecated("plan_stages()",
                "StadiPipeline.plan() returns a fully-populated plan — "
                "read plan.stages")
    return _resolve_stages(plan, model_cfg, config)


def plan_seq(plan: ExecutionPlan, model_cfg, config: StadiConfig):
    """Deprecated: ``StadiPipeline.plan()`` populates ``plan.seq``."""
    _deprecated("plan_seq()",
                "StadiPipeline.plan() returns a fully-populated plan — "
                "read plan.seq")
    return _resolve_seq(plan, model_cfg, config)


def plan_guidance(plan: ExecutionPlan, config: StadiConfig):
    """Deprecated: ``StadiPipeline.plan()`` populates ``plan.guidance``."""
    _deprecated("plan_guidance()",
                "StadiPipeline.plan() returns a fully-populated plan — "
                "read plan.guidance")
    return _resolve_guidance(plan, config)


def _check_frame_knobs(config: StadiConfig, guided: bool) -> None:
    """The frame knobs' validation, with the reference's messages."""
    if config.num_frames < 1:
        raise ValueError(f"num_frames must be >= 1, got {config.num_frames}")
    if config.frame_groups < 0:
        raise ValueError(f"frame_groups must be >= 0 (0 = auto), got "
                         f"{config.frame_groups}")
    if config.num_frames == 1:
        if config.frame_groups > 1:
            raise ValueError(f"frame_groups={config.frame_groups} needs "
                             "num_frames > 1 (there is only one frame to "
                             "place)")
        return
    if config.backend not in FRAME_BACKENDS:
        raise ValueError(
            f"num_frames={config.num_frames} needs a frame backend "
            f"({sorted(FRAME_BACKENDS)}), not {config.backend!r} — "
            "multi-frame diffusion (DESIGN.md §16)")
    if config.frame_groups > config.num_frames:
        raise ValueError(
            f"frame_groups={config.frame_groups} cannot split "
            f"{config.num_frames} frames (>= 1 frame per group)")
    if config.frame_groups > config.n_devices:
        raise ValueError(
            f"frame_groups={config.frame_groups} is infeasible: "
            "every group-member row needs at least one device and "
            f"the cluster has {config.n_devices}")
    if guided and config.guidance in ("split", "interleaved"):
        raise ValueError(
            f"guidance={config.guidance!r} is not composed with "
            "the frame axis: guided video runs FUSED classifier-"
            "free guidance only (branch pairing and frame grouping "
            "compete for the same devices) — use guidance='fused' "
            "or guidance='none' with cfg_scale > 0")
    if config.seq_shards != 1:
        raise ValueError(
            "sequence sharding is not composed with the frame axis "
            "yet (ring groups and frame rows compete for the same "
            "devices) — pin seq_shards=1 with num_frames > 1")
    if config.num_stages != 1:
        raise ValueError(
            "the displaced patch pipeline is not composed with the "
            "frame axis yet — pin num_stages=1 with num_frames > 1")
    if config.rebalance_every:
        raise ValueError("online rebalancing is not supported with "
                         "the frame axis (the frame grouping is "
                         "static)")


def _to_device(tree, device):
    if tree is None:                     # the simulate backend reads no weights
        return None
    return {k: (_to_device(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


class StadiPipeline:
    """One-call STADI inference: plan -> execute -> (optionally) rebalance.

    model_cfg/params/sched describe the denoiser; config describes the
    cluster and strategy; ``device`` is where the numerics run (``cuda``
    unless given). ``generate`` is the only entry point callers need;
    ``plan`` is the one planning entry point.
    """

    def __init__(self, model_cfg: DiTConfig, params, sched: NoiseSchedule,
                 config: StadiConfig, device=None):
        get_planner(config.planner)      # fail fast on typos
        get_executor(config.backend)
        get_exchange(config.exchange, config.exchange_refresh)
        if config.num_stages < 0:
            raise ValueError(f"num_stages must be >= 0 (0 = auto), got "
                             f"{config.num_stages}")
        if config.num_stages > 1 and config.backend not in STAGED_BACKENDS:
            raise ValueError(
                f"num_stages={config.num_stages} needs a staged backend "
                f"({sorted(STAGED_BACKENDS)}), not {config.backend!r} — "
                "the displaced patch pipeline (DESIGN.md §11)")
        if config.guidance != "none" and config.guidance not in GUIDANCE_MODES:
            raise ValueError(f"unknown guidance mode {config.guidance!r}; "
                             f"one of {('none',) + GUIDANCE_MODES}")
        if config.guidance != "none" and config.cfg_scale <= 0.0:
            raise ValueError(f"guidance={config.guidance!r} needs "
                             "cfg_scale > 0")
        guided = config.cfg_scale > 0.0 or config.guidance != "none"
        if guided and config.rebalance_every:
            raise ValueError("online rebalancing is not supported with "
                             "guidance (the branch pairing is static)")
        if config.seq_shards < 0:
            raise ValueError(f"seq_shards must be >= 0 (0 = auto), got "
                             f"{config.seq_shards}")
        if config.seq_shards > config.n_devices:
            raise ValueError(
                f"seq_shards={config.seq_shards} is infeasible: every "
                "patch-worker group needs one device per sequence shard "
                f"and the cluster has {config.n_devices}")
        if config.seq_shards > 1:
            if config.backend not in SEQ_BACKENDS:
                raise ValueError(
                    f"seq_shards={config.seq_shards} needs a seq backend "
                    f"({sorted(SEQ_BACKENDS)}), not {config.backend!r} — "
                    "sequence-parallel attention (DESIGN.md §13)")
            if model_cfg.n_heads < config.seq_shards:
                raise ValueError(
                    f"seq_shards={config.seq_shards} cannot scatter "
                    f"{model_cfg.n_heads} attention heads (Ulysses needs "
                    ">= 1 head per shard)")
            if config.rebalance_every:
                raise ValueError("online rebalancing is not supported with "
                                 "sequence sharding (the device grouping "
                                 "is static)")
        _check_frame_knobs(config, guided)
        if config.cond_bucket < 0:
            raise ValueError(f"cond_bucket must be >= 0 (0 = derive from "
                             f"the model config), got {config.cond_bucket}")
        if config.cond_bucket > 0 and not model_cfg.cross_attn:
            raise ValueError(
                f"cond_bucket={config.cond_bucket} prices prompt-token "
                "cross-attention but the model has cross_attn=False — "
                "use DiTConfig.text_conditioned()")
        if config.cond_bucket > model_cfg.cond_seq_len:
            raise ValueError(
                f"cond_bucket={config.cond_bucket} exceeds the model's "
                f"cond_seq_len={model_cfg.cond_seq_len} (the encoder "
                "never emits a longer prompt bucket)")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.params = _to_device(params, self.device)
        self.sched = sched
        self.config = config
        # persistent plan cache (DESIGN.md §14)
        self.plan_cache = None
        self.last_plan_key: Optional[str] = None
        #: live planner searches actually executed (cache hits skip these)
        self.planner_calls = 0
        if config.plan_cache_dir:
            from repro_torch.serving.plan_cache import PlanCache
            self.plan_cache = PlanCache(config.plan_cache_dir)

    @property
    def p_total(self) -> int:
        return self.model_cfg.tokens_per_side

    def _plan_knobs(self) -> StadiConfig:
        """The config with the model-derived depth, head count, byte sizes
        and prompt bucket filled in, which the staged, guided, seq and frame
        planners price — what planners actually see."""
        knobs = self.config
        if knobs.depth is None:          # stage planning needs the DiT depth
            knobs = dataclasses.replace(knobs, depth=self.model_cfg.n_layers)
        if knobs.n_heads is None:        # seq planning needs the head count
            knobs = dataclasses.replace(knobs, n_heads=self.model_cfg.n_heads)
        if knobs.latent_bytes == 0:
            cfg = self.model_cfg
            knobs = dataclasses.replace(
                knobs,
                latent_bytes=int(cfg.latent_size ** 2 * cfg.channels * 4),
                kv_row_bytes=int(2 * cfg.n_layers * cfg.tokens_per_side
                                 * cfg.d_model * 2))
        if knobs.cond_bucket == 0 and self.model_cfg.cross_attn:
            # a prompt model prices its whole cond_seq_len unless a serving
            # bucket pins a shorter one
            knobs = dataclasses.replace(
                knobs, cond_bucket=self.model_cfg.cond_seq_len)
        return knobs

    def _model_key(self) -> str:
        """Content hash of the model config (DiTConfig is a frozen
        dataclass whose repr is the reference's, so both packages hash one
        config alike)."""
        return hashlib.sha256(repr(self.model_cfg).encode()).hexdigest()[:16]

    def _workload_key(self, knobs: StadiConfig) -> Dict:
        """The workload-shape component of the plan-cache key: every knob
        that changes what the planner returns, as the reference names them,
        so an entry either package writes hits in the other."""
        cm = knobs.cost_model
        return {
            "planner": knobs.planner,
            "p_total": self.p_total,
            "m_base": knobs.m_base, "m_warmup": knobs.m_warmup,
            "a": knobs.a, "b": knobs.b, "tiers": list(knobs.tiers),
            "granularity": knobs.granularity, "min_patch": knobs.min_patch,
            "exchange": knobs.exchange,
            "exchange_refresh": knobs.exchange_refresh,
            "num_stages": knobs.num_stages,
            "micro_patches": knobs.micro_patches, "depth": knobs.depth,
            "guidance": knobs.guidance, "cfg_scale": knobs.cfg_scale,
            "uncond_refresh": knobs.uncond_refresh,
            "latent_bytes": knobs.latent_bytes,
            "kv_row_bytes": knobs.kv_row_bytes,
            "seq_shards": knobs.seq_shards, "n_heads": knobs.n_heads,
            "num_frames": knobs.num_frames,
            "frame_groups": knobs.frame_groups,
            "cond_bucket": knobs.cond_bucket,
            "cross_attn": bool(self.model_cfg.cross_attn),
            "cost_model": (None if cm is None else dataclasses.asdict(cm)),
        }

    def plan(self, speeds: Optional[Sequence[float]] = None, *,
             use_cache: bool = True) -> ExecutionPlan:
        """Run the configured planner (no execution); the plan's stage,
        guidance, seq and frame axes are resolved from the planner output or
        the config in the same pass. With a plan cache configured, the persistent cache is
        consulted before any planner search (``use_cache=False`` forces a
        live search without touching the cache)."""
        speeds = list(speeds) if speeds is not None else self.config.speeds
        knobs = self._plan_knobs()
        key = None
        if self.plan_cache is not None and use_cache:
            key = self.plan_cache.signature(speeds, self._model_key(),
                                            self._workload_key(knobs))
            hit = self.plan_cache.get(key)
            if hit is not None:
                self.last_plan_key = key
                return hit
        raw = get_planner(self.config.planner)(speeds, knobs, self.p_total)
        self.planner_calls += 1
        plan = dataclasses.replace(
            raw, stages=_resolve_stages(raw, self.model_cfg, knobs),
            guidance=_resolve_guidance(raw, knobs),
            seq=(raw.seq if raw.seq is not None
                 else _resolve_seq(raw, self.model_cfg, knobs)),
            frames=(raw.frames if raw.frames is not None
                    else _resolve_frames(raw, knobs)))
        if key is not None:
            self.plan_cache.put(key, plan)
            self.last_plan_key = key
        return plan

    def generate(self, x_T=None, cond=None, *,
                 measured_speeds: Optional[Sequence[float]] = None
                 ) -> PipelineResult:
        """Plan and execute one generation on the pipeline's device.

        measured_speeds: ground-truth effective speeds the run experiences
        (defaults to the configured cluster's). When they drift from the
        planned speeds and ``rebalance_every`` is on, the profiler detects it
        and the remaining steps are re-planned mid-run.
        """
        with spans.span("generate", backend=self.config.backend):
            return self._generate(x_T, cond, measured_speeds)

    def _generate(self, x_T, cond, measured_speeds) -> PipelineResult:
        config = self.config
        plan = self.plan()
        check_backend_can_run(plan, config)
        replans: List[ReplanEvent] = []
        hook = None
        if config.rebalance_every > 0:
            if config.backend != "emulated":
                raise ValueError("rebalance_every requires the 'emulated' "
                                 f"backend, not {config.backend!r}")
            hook = self._make_rebalance_hook(plan, measured_speeds, replans)
        if config.backend == "simulate" and config.cost_model is None:
            raise ValueError("the 'simulate' backend needs config.cost_model")
        if x_T is not None:
            x_T = x_T.to(self.device)
        if cond is not None:
            cond = torch.as_tensor(cond).to(self.device)
        before = kops.launch_counts()
        image, trace = get_executor(config.backend)(
            params=self.params, model_cfg=self.model_cfg, sched=self.sched,
            x_T=x_T, cond=cond, plan=plan, config=config,
            interval_hook=hook)
        launches = {k: n - before.get(k, 0)
                    for k, n in kops.launch_counts().items()
                    if n != before.get(k, 0)}
        latency = None
        if config.cost_model is not None:
            lat_speeds = (list(measured_speeds) if measured_speeds is not None
                          else config.speeds)
            latency = sim.simulate_trace(trace, lat_speeds, config.cost_model)
        return PipelineResult(image, trace, plan, latency, replans,
                              {"launches": launches})

    def generate_many(self, x_Ts: Sequence, conds: Sequence, *,
                      slots: int = 4) -> List[PipelineResult]:
        """Continuous-batched generation of many requests (serving engine).

        Admits all requests into a :class:`repro_torch.serving.
        diffusion_engine.DiffusionServingEngine` with ``slots`` concurrent
        lanes and drains them; per-request images match :meth:`generate`
        on the emulated backend (within float tolerance: a lane group runs
        its lanes as one batch). Each result's ``latency_s`` is the
        per-request modeled serving latency (queueing + batched service, via
        the cost model) rather than the single-request makespan — None when
        no cost model is configured. Results come back in submission order;
        ``kernel_stats`` holds the launches of the whole drain. For SLO
        verdicts and round-level stats, drive a DiffusionServingEngine
        directly.
        """
        from repro_torch.serving.diffusion_engine import DiffusionServingEngine
        if len(x_Ts) != len(conds):
            raise ValueError(f"{len(x_Ts)} inputs vs {len(conds)} conds")
        engine = DiffusionServingEngine(self, slots=slots)
        reqs = [engine.submit(x, c) for x, c in zip(x_Ts, conds)]
        engine.run_to_completion()
        trace = sim.build_trace(engine.plan.temporal, engine.plan.patches,
                                self.model_cfg, batch=1,
                                exchange=self.config.exchange,
                                exchange_refresh=self.config.exchange_refresh,
                                stages=engine.stages,
                                guidance=engine.plan.guidance)
        report_latency = self.config.cost_model is not None
        kernel_stats = {"launches": engine.stats()["kernels"]}
        return [PipelineResult(r.image, trace, engine.plan,
                               r.modeled_latency_s if report_latency else None,
                               kernel_stats=kernel_stats)
                for r in reqs]

    # ------------------------------------------------------------------
    # online rebalancing (beyond-paper §7.1): OnlineProfiler in the hot path
    # ------------------------------------------------------------------

    def _make_rebalance_hook(self, plan: ExecutionPlan,
                             measured_speeds: Optional[Sequence[float]],
                             replans: List[ReplanEvent]):
        config = self.config
        cm = config.cost_model or CostModel(t_fixed=1e-3, t_row=1e-3)
        true_speeds = (list(measured_speeds) if measured_speeds is not None
                       else config.speeds)
        profiler = hetero.OnlineProfiler(plan.speeds, alpha=config.profiler_alpha)
        state = {"baseline": list(plan.speeds), "since": 0}

        def hook(next_fine_step: int, ev):
            # feed measured per-device interval latencies into the profiler;
            # work is nominal seconds at v=1 so observed_v converges on the
            # device's true effective speed
            hetero.feed_profiler(profiler, cm, ev.substeps, ev.patches,
                                 true_speeds)
            state["since"] += 1
            if state["since"] < config.rebalance_every:
                return None
            state["since"] = 0
            drift = profiler.drift(state["baseline"])
            if drift <= config.rebalance_threshold:
                return None
            f_rem = plan.temporal.m_base - next_fine_step
            tiers = tuple(t for t in config.tiers if f_rem % t == 0) or (1,)
            knobs = dataclasses.replace(config, m_base=f_rem, m_warmup=0,
                                        tiers=tiers)
            new = get_planner(config.planner)(profiler.speeds, knobs,
                                              self.p_total)
            if f_rem % new.temporal.lcm:
                return None              # cannot fit an interval; keep going
            if self.plan_cache is not None and self.last_plan_key:
                # the persisted plan was computed from speeds that no
                # longer hold — drop it so the next plan() re-searches
                self.plan_cache.invalidate(self.last_plan_key)
            replans.append(ReplanEvent(next_fine_step, drift,
                                       list(state["baseline"]),
                                       list(profiler.speeds), new))
            state["baseline"] = list(profiler.speeds)
            return new.temporal, new.patches

        return hook
