"""Slot-based continuous batching for diffusion requests over StadiPipeline
— the port of ``repro.serving.diffusion_engine`` (DESIGN.md §9): its
emulated, pipefuse and multi-rank spmd lanes.

Each :class:`DiffusionRequest` carries its own position on the fine DDIM
grid, so requests admitted at different times coexist in one denoise
dispatch:

    pipe   = StadiPipeline(cfg, params, sched, config)      # any planner
    engine = DiffusionServingEngine(pipe, slots=8)
    reqs   = [engine.submit(x_T, cond) for ...]             # FIFO queue
    engine.run_to_completion()
    stats  = engine.stats()          # per-request latency / SLO, throughput

One scheduling **round** = admit (FIFO, lowest free slot) -> one warmup fine
step for warmup-phase lanes -> one adaptive interval (``plan.lcm`` fine
steps) for adaptive-phase lanes -> retire finished lanes. All per-lane state
(latent, stale-K/V buffers, class condition, guidance scale) lives in
slot-major tensors on the pipeline's device.

Where the reference ``jax.vmap``s one request's step over the lanes, the port
folds a lane group into the batch axis: a group of G lanes is ONE denoiser
dispatch at batch G (2G for guided lanes, both branches in the batch), so K1
runs once a layer for the whole group, each lane at its own timestep
(:func:`repro_torch.models.diffusion.dit._cond_vector` takes one timestep a
row), and a guided group ends in ONE launch of kernel K3 with a vector of
the lanes' scales (:func:`repro_torch.kernels.ops.cfg_epilogue`). The stale
K/V state is laid out so a group's layer read is a view: ``[L, slots, N, H,
hd]`` plain and ``[L, 2, slots, N, H, hd]`` guided (branch 0 conditional).
A group of consecutive slots reads the state in place; any other group is
gathered once an interval. Nothing is padded to the slot count: eager
dispatches have no compiled shapes to keep stable.

Numerics: the emulated stepper mirrors ``patch_parallel.run_schedule``
step for step — the same DDIM updates, publish at the first substep, merge
at the interval boundary in ascending worker order — so every request's
image matches a lone ``pipe.generate`` within float tolerance (a batched
product may sum in another order than a batch-1 one; the reference's own
bitwise check of this fails under jax 0.9.0 for the same reason). The latent
lives in the model's activation dtype (``cfg.dtype``), as a lone generate's
does for an x_T of that dtype; the reference keeps it in float32.

Latency: every round is costed against ``StadiConfig.cluster`` with the
``simulate`` cost model — per-round device placement assigns the heaviest
patch-worker load to the fastest device (deterministic) — and each request
accrues modeled wall-clock from submission to completion, giving queueing +
service latency and SLO accounting that tests can assert exactly.

The ``pipefuse`` stepper serves the displaced stage chain (DESIGN.md §11):
at one stage it is the emulated stepper; at S > 1 every lane carries its
own displaced contexts ``[L, slots, N, H, hd]``, refilled from the published
buffers on the intervals the IR's StageShift names, and the round cost
prices the stage chain. It serves unguided lanes only at S > 1, as the
reference does.

The ``spmd`` stepper runs each adaptive interval across the ranks of a
``torch.distributed`` process group
(:func:`repro_torch.core.spmd.make_interval_step`, kernel K2 in every
block), on cohorts of lanes that share a fine step. Where the reference
drives the devices from one controller, every rank here builds the same
engine, receives the same submissions and runs the same rounds; admission
is FIFO and the clock modeled, so the rounds agree, and each interval is a
collective call. Warm-up steps run on every rank. It serves unguided lanes
and refuses online replanning, as the reference does.

Video lanes (DESIGN.md §16): with a multi-frame plan a request is one
clip ``[1, F, H, W, C]``, whose cross-frame K/V state lives per clip, so
each admitted clip runs its whole schedule in its round through the
configured frame executor (``emulated`` or ``spmd_frames``; on the latter
every rank builds the same engine, as with the spmd stepper) and accrues the
frame-priced makespan of :func:`repro_torch.core.simulate.simulate_trace`.

Prompt lanes (DESIGN.md §17): with a text-conditioned model every request
carries prompt tokens ``[1, L, cond_dim + 1]``
(:func:`repro_torch.models.text_encoder.encode`), whose length bucket L
varies by request. The tokens live on the requests; a lane group stacks its
lanes' and the bucket joins every lane-group key, so one dispatch never
mixes buckets, and every round is priced with the group's bucket
(``CostModel.t_xattn`` a prompt token a row). The displaced stage chain has
no prompt cross-attention, so a staged ``pipefuse`` engine refuses prompts.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import buffers as buf_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import events as ir
from repro_torch.core import hetero
from repro_torch.core import pipefuse as pipefuse_lib
from repro_torch.core import sampler as sampler_lib
from repro_torch.core import simulate as sim
from repro_torch.core.pipeline import (ReplanEvent, StadiPipeline,
                                       check_backend_can_run, get_executor,
                                       get_stepper_factory,
                                       register_stepper_factory)
from repro_torch.core.planners import ExecutionPlan
from repro_torch.core.schedule import patch_bounds
from repro_torch.core.simulate import CostModel
from repro_torch.kernels import ops as kops
from repro_torch.models.diffusion import dit


@dataclasses.dataclass
class DiffusionRequest:
    """One queued generation request plus its serving statistics.

    ``fine_step`` is the request's own position on the fine DDIM grid
    (0..m_base); the engine advances it by 1 per warmup round and by
    ``plan.lcm`` per adaptive round.
    """
    uid: int
    x_T: torch.Tensor                    # [1, H, W, C]
    # [1] int32 class id, or [1, L, cond_dim+1] prompt tokens
    cond: torch.Tensor
    slo_s: Optional[float] = None        # modeled-latency SLO target
    # classifier-free guidance (DESIGN.md §12): None = unguided request;
    # > 0 = this request denoises with eps_u + cfg_scale*(eps_c - eps_u)
    # (per-lane state; CFG and non-CFG requests coexist in one batch)
    cfg_scale: Optional[float] = None

    @property
    def guided(self) -> bool:
        return self.cfg_scale is not None and self.cfg_scale > 0.0
    # engine-owned state
    fine_step: int = 0
    image: Optional[torch.Tensor] = None
    done: bool = False
    preempt_count: int = 0               # evictions back to the queue head
    # statistics (rounds are engine scheduling rounds; latency is modeled
    # wall-clock on the configured cluster, queueing included)
    submit_round: int = -1
    admit_round: int = -1
    finish_round: int = -1
    submit_clock_s: float = 0.0
    modeled_latency_s: float = 0.0
    wall_latency_s: float = 0.0
    _submit_wall: float = 0.0

    @property
    def queue_rounds(self) -> int:
        return self.admit_round - self.submit_round

    @property
    def slo_met(self) -> Optional[bool]:
        if self.slo_s is None or not self.done:
            return None
        return self.modeled_latency_s <= self.slo_s


@dataclasses.dataclass
class RoundReport:
    """What one scheduling round did (admissions, groups, placement, cost)."""
    index: int
    admitted: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    warmup_lanes: List[int] = dataclasses.field(default_factory=list)
    adaptive_lanes: List[int] = dataclasses.field(default_factory=list)
    exchange_kinds: List[str] = dataclasses.field(default_factory=list)
    placement: Optional[Tuple[Tuple[int, int], ...]] = None  # (worker, device)
    modeled_s: float = 0.0
    wall_s: float = 0.0


# ----------------------------------------------------------------------
# lane-group denoiser dispatches: one forward covers every lane of a group
# ----------------------------------------------------------------------
#
# xs [G, rows, W, C] and ts [G] (each lane's timestep); conds [G]; plain
# buffers [L, G, N, H, hd], guided ones [L, 2, G, N, H, hd]. The reference's
# counterparts are _vmap_full_step, _vmap_patch_step,
# _vmap_guided_full_step and _vmap_guided_patch_step.

def _lane_cfg_combine(eps2, scales):
    """The guided group's CFG combine: kernel K3 once over [G, ...] with
    lane g at ``scales[g]`` (on the CPU its plain version)."""
    return kops.cfg_epilogue(eps2[0], eps2[1], scales, with_delta=False)


def _lane_full_step(params, cfg, xs, ts, conds):
    """Synchronous full-image step of a lane group: (eps, (k, v))."""
    return dit.forward_patch(params, cfg, xs, ts, conds, 0, buffers=None)


def _lane_patch_step(params, cfg, xs_loc, ts, conds, bks, bvs, row_start,
                     return_kv):
    """Stale-K/V patch step of a lane group: (eps, (k, v) or None)."""
    return dit.forward_patch(params, cfg, xs_loc, ts, conds, row_start,
                             buffers=(bks, bvs), return_kv=return_kv)


def _lane_guided_full_step(params, cfg, xs, ts, conds, scales):
    """Guided synchronous step: (eps, branch-stacked (k2, v2) [L, 2, G, N,
    H, hd])."""
    eps2, kv2 = dit.forward_patch_cfg(params, cfg, xs, ts, conds, 0,
                                      branch_axis=1)
    return _lane_cfg_combine(eps2, scales), kv2


def _lane_guided_patch_step(params, cfg, xs_loc, ts, conds, bk2s, bv2s,
                            scales, row_start, return_kv):
    """Guided stale-K/V patch step against branch-stacked buffers."""
    eps2, kv2 = dit.forward_patch_cfg(params, cfg, xs_loc, ts, conds,
                                      row_start, buffers=(bk2s, bv2s),
                                      return_kv=return_kv, branch_axis=1)
    return _lane_cfg_combine(eps2, scales), kv2


class _LaneWarmupMixin:
    """Warmup steps shared by the steppers (the reference's
    ``_VmapWarmupMixin``): synchronous full-image forwards of a lane group,
    each lane at its own timestep. ``dispatches`` counts the denoiser
    dispatches by kind ("plain", "guided") and the lanes they carried
    ("plain_lanes", "guided_lanes"); the engine shares one counter across
    the steppers it builds."""

    #: can this stepper run guided (CFG) lanes? (DESIGN.md §12)
    supports_guidance = False
    #: does every lane of one interval call have to share its fine step?
    cohort_only = False

    def _init_warmup(self, params, model_cfg, sched):
        self.params = params
        self.model_cfg = model_cfg
        self.sched = sched
        self.dispatches: collections.Counter = collections.Counter()

    def _count(self, kind: str, lanes: int) -> None:
        self.dispatches[kind] += 1
        self.dispatches[kind + "_lanes"] += lanes

    def _warmup_finish(self, xs, t_from, t_to, eps, ks, vs):
        shape = (xs.shape[0],) + (1,) * (xs.dim() - 1)
        xs = sampler_lib.ddim_step(self.sched, xs, eps, t_from.reshape(shape),
                                   t_to.reshape(shape))
        return xs, ks, vs

    def warmup_step(self, xs, t_from, t_to, conds):
        """One synchronous fine step per lane: returns (xs', k, v) with the
        fresh K/V [L, G, N, H, hd]."""
        self._count("plain", xs.shape[0])
        eps, (ks, vs) = _lane_full_step(self.params, self.model_cfg, xs,
                                        t_from, conds)
        return self._warmup_finish(xs, t_from, t_to, eps, ks, vs)

    def warmup_step_guided(self, xs, t_from, t_to, conds, scales):
        """Guided synchronous step per lane: returns (xs', k2, v2) with
        branch-stacked fresh K/V [L, 2, G, N, H, hd]."""
        self._count("guided", xs.shape[0])
        eps, (k2s, v2s) = _lane_guided_full_step(
            self.params, self.model_cfg, xs, t_from, conds, scales)
        return self._warmup_finish(xs, t_from, t_to, eps, k2s, v2s)


@register_stepper_factory("emulated")
class EmulatedStepper(_LaneWarmupMixin):
    """Lane-batched mirror of ``run_schedule``'s adaptive loop: per (worker,
    substep) one denoiser dispatch covers every lane of a group, and lanes
    may sit at different fine steps (the timestep is per-lane data)."""

    supports_guidance = True

    def __init__(self, pipeline: StadiPipeline, plan: ExecutionPlan,
                 slots: int):
        self._init_warmup(pipeline.params, pipeline.model_cfg, pipeline.sched)
        self.plan = plan
        self._ts = sampler_lib.ddim_timesteps(pipeline.sched.T,
                                              plan.temporal.m_base)

    def _interval_impl(self, xs, fine0, pub_k, pub_v, merge, step_fn,
                       tok_axis):
        """The ONE lane-interval loop every entry point shares: per (fine
        step, worker) one ``step_fn`` dispatch covers every lane, in the
        substep-major micro order of the stage chain (each worker's slab
        reads only the interval's buffers, so the order changes no number
        of the unstaged steps), slabs scatter back, and first-substep K/V
        merges into the buffers at ``tok_axis`` (2 plain, 3 branch-stacked)
        in ascending worker order — mirroring ``buffers.merge``."""
        plan, cfg = self.plan.temporal, self.model_cfg
        R, p = plan.lcm, cfg.patch_size
        G = xs.shape[0]
        fine0 = torch.as_tensor(np.asarray(fine0), dtype=torch.int64)
        bounds_tok = patch_bounds(self.plan.patches)
        workers = [i for i in plan.active if self.plan.patches[i] > 0]
        tshape = (G,) + (1,) * (xs.dim() - 1)

        pending = {}
        slabs = {i: xs[:, bounds_tok[i][0] * p:bounds_tok[i][1] * p]
                 for i in workers}
        for f in range(R):
            for i in workers:
                r = plan.ratios[i]
                if f % r:
                    continue
                t_from = self._ts[fine0 + f]
                t_to = self._ts[fine0 + f + r]
                eps, kv = step_fn(slabs[i], t_from, bounds_tok[i][0], f == 0)
                slabs[i] = sampler_lib.ddim_step(self.sched, slabs[i], eps,
                                                 t_from.reshape(tshape),
                                                 t_to.reshape(tshape))
                if f == 0:           # Alg.1: publish the first substep's KV
                    pending[i] = kv
        # interval boundary: all-gather of x + buffer merge (same order as
        # buffers.merge: ascending worker id)
        xs = xs.clone()
        for i in workers:
            xs[:, bounds_tok[i][0] * p:bounds_tok[i][1] * p] = slabs[i]
        if merge:
            for i in sorted(pending):
                k, v = pending[i]
                start = bounds_tok[i][0] * cfg.tokens_per_side
                n = k.shape[tok_axis]
                pub_k.narrow(tok_axis, start, n).copy_(k)
                pub_v.narrow(tok_axis, start, n).copy_(v)
        return xs, pub_k, pub_v

    def interval(self, xs, fine0, conds, pub_k, pub_v, merge: bool = True):
        """One adaptive interval (plan.lcm fine steps) for every lane.

        xs [G, H, W, C]; fine0 int per lane; pub_{k,v} [L, G, N, H, hd] —
        the READ buffers (the engine passes extrapolated copies for
        predictive boundaries), which the boundary merge writes in place:
        the caller owns them. ``merge=False`` is the "skip"/"predict"
        trailing boundary: fresh K/V is never broadcast, the buffers come
        back untouched. Returns (xs', pub_k, pub_v).
        """
        def step(x_loc, t_from, row0, first):
            self._count("plain", x_loc.shape[0])
            return _lane_patch_step(self.params, self.model_cfg, x_loc,
                                    t_from, conds, pub_k, pub_v, row0, first)
        return self._interval_impl(xs, fine0, pub_k, pub_v, merge, step,
                                   tok_axis=2)

    def interval_guided(self, xs, fine0, conds, scales, pub_k, pub_v,
                        merge: bool = True):
        """One adaptive interval for GUIDED lanes (DESIGN.md §12): the
        same worker/substep structure as :meth:`interval`, every denoiser
        dispatch a branch-batched fused-CFG eval against branch-stacked
        buffers pub_{k,v} [L, 2, G, N, H, hd] ending in one K3 launch;
        scales [G] (float32, on the lanes' device) is per-lane data."""
        def step(x_loc, t_from, row0, first):
            self._count("guided", x_loc.shape[0])
            return _lane_guided_patch_step(self.params, self.model_cfg,
                                           x_loc, t_from, conds, pub_k,
                                           pub_v, scales, row0, first)
        return self._interval_impl(xs, fine0, pub_k, pub_v, merge, step,
                                   tok_axis=3)


@register_stepper_factory("pipefuse")
class PipefuseStepper(EmulatedStepper):
    """Displaced stage-chain serving (DESIGN.md §11): at one stage this IS
    the EmulatedStepper; at S > 1 each interval runs the substep-major micro
    order of ``pipefuse.run_pipefuse`` over the lanes' displaced contexts,
    so every lane's image matches a lone ``generate`` on the pipefuse
    backend (within float tolerance: a lane group is one batched forward)."""

    def __init__(self, pipeline: StadiPipeline, plan: ExecutionPlan,
                 slots: int):
        super().__init__(pipeline, plan, slots)
        self.stages = plan.stages or [pipeline.model_cfg.n_layers]
        self.bounds = pipefuse_lib.stage_bounds(self.stages)

    @property
    def wants_ctx(self) -> bool:
        return len(self.stages) > 1

    @property
    def supports_guidance(self) -> bool:
        # at one stage this IS the EmulatedStepper; the lanes' displaced
        # contexts carry no guided branch state, as in the reference
        return not self.wants_ctx

    def interval_ctx(self, xs, fine0, conds, pub_k, pub_v, ctx_k, ctx_v,
                     merge: bool = True):
        """One adaptive interval through the stage chain for every lane.

        ctx_{k,v} [L, G, N, H, hd] are the lanes' displaced contexts (the
        engine resets them to the published buffers on fill intervals),
        written in place; pub_{k,v} as in :meth:`interval`. Returns (xs',
        pub_k, pub_v, ctx_k, ctx_v)."""
        def step(x_loc, t_from, row0, first):
            self._count("plain", x_loc.shape[0])
            eps, k, v, _, _ = pipefuse_lib.displaced_step(
                self.params, self.model_cfg, x_loc, t_from, conds, row0,
                ctx_k, ctx_v, self.bounds)
            return eps, (k, v)
        xs, pub_k, pub_v = self._interval_impl(xs, fine0, pub_k, pub_v, merge,
                                               step, tok_axis=2)
        return xs, pub_k, pub_v, ctx_k, ctx_v


@register_stepper_factory("spmd")
class SpmdStepper(_LaneWarmupMixin):
    """Adaptive intervals across the ranks of the default process group
    (:func:`repro_torch.core.spmd.make_interval_step`): the lanes of one
    call are stacked on the batch axis and must share a fine step
    (``cohort_only``), so the engine groups cohorts by ``fine_step``. Every
    rank builds the same engine and makes the same calls. Warm-up steps run
    on every rank (a synchronous step is the exact full-image forward,
    which the multi-rank executors also run on every rank). Dispatches of
    kind "padded" count this rank's patch forwards (kernel K2 in each of
    their blocks)."""

    cohort_only = True

    def __init__(self, pipeline: StadiPipeline, plan: ExecutionPlan,
                 slots: int):
        from repro_torch.core import spmd
        self._init_warmup(pipeline.params, pipeline.model_cfg, pipeline.sched)
        self.plan = plan
        self._steps = {kind: spmd.make_interval_step(
            pipeline.model_cfg, pipeline.sched, plan.temporal, plan.patches,
            exchange_kind=kind) for kind in ("full", "skip")}

    def interval(self, xs, fine0, conds, pub_k, pub_v, merge: bool = True):
        """One adaptive interval of a cohort, as
        :meth:`EmulatedStepper.interval`; returns new buffers."""
        fine0 = np.asarray(fine0)
        if not (fine0 == fine0[0]).all():
            raise ValueError("the spmd stepper is cohort-only: the lanes of "
                             f"one call must share a fine step, got {fine0}")
        fn = self._steps["full" if merge else "skip"]
        self.dispatches["padded"] += fn.substeps
        self.dispatches["padded_lanes"] += fn.substeps * xs.shape[0]
        return fn(self.params, xs, conds, pub_k, pub_v, int(fine0[0]))


#: a lane group's index into slot-major state: a slice for consecutive
#: slots (views of the state), else a device index tensor (gathers)
LaneIndex = Union[slice, torch.Tensor]


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

class DiffusionServingEngine:
    """Continuous batching of diffusion requests over one StadiPipeline.

    Admission: FIFO queue into the lowest free slot at the start of every
    round; a slot freed this round is refilled next round. Placement: each
    round the plan's patch-workers are assigned to cluster devices by the
    cost model (heaviest load -> fastest device, deterministic ties), and the
    modeled round time — batched compute, boundary all-gather, masked async
    KV — is accrued to every in-flight request.
    """

    def __init__(self, pipeline: StadiPipeline, *, slots: int = 4,
                 cost_model: Optional[CostModel] = None,
                 rebalance_every: int = 0,
                 rebalance_threshold: float = 0.2,
                 measured_speeds: Optional[Sequence[float]] = None):
        config = pipeline.config
        if config.rebalance_every:
            raise ValueError("serving drives placement per round; disable "
                             "rebalance_every on the pipeline config (the "
                             "engine's own rebalance_every kwarg replans "
                             "between rounds)")
        if slots < 1:
            raise ValueError("need at least one slot")
        self.pipeline = pipeline
        self.slots = slots
        self.device = pipeline.device
        self.plan = pipeline.plan()
        check_backend_can_run(self.plan, config)
        # classifier-free guidance (DESIGN.md §12/§14): serving batches
        # FUSED lane groups (every worker computes both branches) and SPLIT
        # lane groups (workers are cond/uncond device PAIRS, eps exchanged
        # between dispatches — same numerics by construction, pair-placed
        # cost). Interleaved uncond reuse remains a per-generation
        # optimization.
        gplan = self.plan.guidance
        if gplan is not None and gplan.mode == "interleaved":
            raise ValueError(
                "serving batches fused- or split-CFG lane cohorts; "
                "'interleaved' uncond reuse is per-generation — use "
                "pipe.generate, or set guidance='fused'|'split'")
        self.default_scale = gplan.scale if gplan is not None else None
        self.cm = cost_model or config.cost_model
        # placement needs SOME cost model; flag the uncalibrated fallback so
        # modeled latencies / SLO verdicts are never mistaken for calibrated
        self.cm_calibrated = self.cm is not None
        if self.cm is None:
            self.cm = CostModel(t_fixed=1e-3, t_row=1e-3)
        # frame axis (DESIGN.md §16): video lanes. The cross-frame K/V state
        # lives per CLIP, so a clip runs its whole schedule in the round it
        # is admitted (a run-to-completion cohort) and the lanes' slot-major
        # state below is never allocated
        self.frames = self.plan.frames
        if self.frames is not None and self.frames.num_frames < 2:
            self.frames = None
        if self.frames is not None and rebalance_every:
            raise ValueError(
                "the frame grouping is static — engine replanning would "
                "re-deal the frame-group rows; serve video plans with "
                "rebalance_every=0")
        cfg = pipeline.model_cfg
        dev = self.device
        self._ts = sampler_lib.ddim_timesteps(pipeline.sched.T,
                                              self.plan.temporal.m_base)
        H, C = cfg.latent_size, cfg.channels
        lanes = 0 if self.frames is not None else slots
        self._kdt = dit._torch_dtype(cfg.dtype)
        self._x = torch.zeros((lanes, H, H, C), dtype=self._kdt, device=dev)
        self._kshape = dit.buffer_shape(cfg, lanes)     # [L, slots, N, H, hd]
        self._pub_k = torch.zeros(self._kshape, dtype=self._kdt, device=dev)
        self._pub_v = torch.zeros(self._kshape, dtype=self._kdt, device=dev)
        self._cond = torch.zeros(lanes, dtype=torch.int32, device=dev)
        # prompt lanes: the tokens' bucket varies by request, so they live
        # on the requests and a lane group stacks its own (_conds)
        self._prompt_mode = bool(cfg.cross_attn)
        #: denoiser dispatches by (guided, prompt bucket); bucket 0 = class
        self.bucket_dispatches: collections.Counter = collections.Counter()
        # guided lanes: branch-stacked published K/V [L, 2, slots, N, H, hd]
        # + the per-slot cfg_scale on the device (K3 reads it in place);
        # the buffers are allocated on the first guided submission so
        # CFG-free serving carries no extra state
        self._kshape2 = (self._kshape[0], 2) + self._kshape[1:]
        self._gk = self._gv = None
        self._prev_gk = self._prev_gv = None
        self._prev_k = self._prev_v = None
        self._scales = torch.zeros(lanes, dtype=torch.float32, device=dev)
        # displaced stage chain (DESIGN.md §11): the lanes' displaced
        # contexts, only materialized when the depth is partitioned
        self.stages = self.plan.stages
        staged = self.stages is not None and len(self.stages) > 1
        self._ctx_k = torch.zeros_like(self._pub_k) if staged else None
        self._ctx_v = torch.zeros_like(self._pub_v) if staged else None
        # sequence-parallel attention (DESIGN.md §13): seq sharding
        # repartitions WHERE attention runs (device groups + ring hops),
        # never WHAT is computed, so the emulated stepper serves seq-sharded
        # lanes unchanged — only the lane group key (per-interval ring hop
        # count) and the modeled round cost see the shards.
        self.seq = self.plan.seq
        if self.seq is not None and len(self.seq.segments) < 2:
            self.seq = None
        if self.seq is not None and staged:
            raise ValueError(
                "serving does not compose sequence sharding with a "
                "displaced stage chain; run seq-sharded lanes on the "
                "single-stage 'emulated' backend")
        self._seq_groups = None
        self._seq_seg_pad = 0.0
        if self.seq is not None:
            from repro_torch.core import seqpar
            groups, _ = seqpar.seq_group_speeds(list(config.speeds),
                                                self.seq.n_shards)
            self._seq_groups = groups
            self._seq_seg_pad = max(self.seq.seg_fracs)
        self.policy = comm_lib.get_exchange(config.exchange,
                                            config.exchange_refresh)
        # online replanning (DESIGN.md §7.1 composed with §12/§14): the
        # ground-truth speeds the cluster actually runs at (emulation's
        # stand-in for per-interval timers), the drift profiler, and the
        # replan cadence. With split guidance a replan re-pairs the
        # cond/uncond device groups (the stadi_guidance planner re-runs
        # guidance_groups over the profiled speeds).
        self.measured_speeds = (list(measured_speeds)
                                if measured_speeds is not None
                                else list(config.speeds))
        if len(self.measured_speeds) != config.n_devices:
            raise ValueError(f"measured_speeds has "
                             f"{len(self.measured_speeds)} entries for a "
                             f"{config.n_devices}-device cluster")
        self.rebalance_every = int(rebalance_every)
        self.rebalance_threshold = rebalance_threshold
        self.replans: List[ReplanEvent] = []
        self.preemptions = 0
        self._pending_plan: Optional[Tuple[ExecutionPlan, float]] = None
        self._rounds_since_check = 0
        self.profiler: Optional[hetero.OnlineProfiler] = None
        if self.rebalance_every:
            if staged or self.seq is not None:
                raise ValueError(
                    "engine replanning re-deals patch workers; staged / "
                    "seq-sharded plans pin their device grouping — serve "
                    "them with rebalance_every=0")
            self.profiler = hetero.OnlineProfiler(
                list(config.speeds), alpha=config.profiler_alpha)
            self._baseline = list(config.speeds)
        # kernel launches and denoiser dispatches since construction
        self._launch_base = kops.launch_counts()
        self.dispatches: collections.Counter = collections.Counter()
        self.queue: List[DiffusionRequest] = []
        self.active: Dict[int, DiffusionRequest] = {}   # slot -> request
        self.completed: List[DiffusionRequest] = []
        self.rounds: List[RoundReport] = []
        self.modeled_clock_s = 0.0
        self._next_uid = 0
        self._install_plan(self.plan)
        if self.rebalance_every and self.stepper.cohort_only:
            raise ValueError("engine replanning rebuilds the lane stepper "
                             "per plan; the cohort-only (spmd) stepper "
                             "compiles one static program — serve it with "
                             "rebalance_every=0")

    def _install_plan(self, plan: ExecutionPlan) -> None:
        """(Re)build every plan-derived piece of engine state: the lane
        stepper, the split-guidance pair map, the per-fine-step boundary
        info, the predictive-extrapolation buffers, and the comm byte
        sizing. Called once at construction and again at every online
        replan (same m_base/m_warmup grid; staged and seq replans are
        rejected up front)."""
        pipeline, config = self.pipeline, self.pipeline.config
        cfg = pipeline.model_cfg
        self.plan = plan
        if self.frames is not None:
            # video lanes: no lane stepper; every clip runs the frame
            # executor, and its modeled cost is the frame-priced trace the
            # simulate backend replays
            self._guide_pairs = None
            self.stepper = None
            self._interval_info = {}
            self._track_prev = False
            trace = sim.build_trace(plan.temporal, plan.patches, cfg,
                                    batch=1, exchange=config.exchange,
                                    exchange_refresh=config.exchange_refresh,
                                    frames=self.frames,
                                    guidance=plan.guidance,
                                    cond_tokens=(config.cond_bucket or None))
            self._latent_bytes = trace.latent_bytes
            self._kv_bytes = trace.kv_bytes_per_worker
            self._act_row_bytes = trace.act_row_bytes
            self._clip_cost_s = sim.simulate_trace(
                trace, self.measured_speeds, self.cm)
            return
        gplan = plan.guidance
        # split-guidance lane groups: logical worker i is the device pair
        # (cond_devices[i], uncond_devices[i]) — used for pair-placed round
        # costs and for feeding the profiler both pair members
        self._guide_pairs = (list(zip(gplan.cond_devices,
                                      gplan.uncond_devices))
                             if gplan is not None and gplan.mode == "split"
                             else None)
        self.stepper = get_stepper_factory(config.backend)(
            pipeline, plan, self.slots)
        self.stepper.dispatches = self.dispatches
        if (self.default_scale is not None
                and not self.stepper.supports_guidance):
            raise ValueError(f"backend {config.backend!r} has no guided "
                             "serving stepper (guided lanes need "
                             "'emulated' or single-stage 'pipefuse')")
        staged = self.stages is not None and len(self.stages) > 1
        # boundary-exchange policy (DESIGN.md §10): replay the SAME schedule
        # IR every lane follows and precompute, per adaptive-interval start
        # fine step, (read_factor, trail_kind, fill, seq_hops): read_factor
        # is the K/V extrapolation coefficient applied BEFORE the interval
        # (0.0 = fresh/stale reuse), trail_kind the exchange at the boundary
        # AFTER it, fill whether the stage chain refills entering it,
        # seq_hops the interval's ring hops. Lanes are grouped by this info,
        # so one batched dispatch never mixes boundary behaviors.
        self._interval_info: Dict[int, Tuple[float, str, bool, int]] = {}
        read_factor = 0.0
        m_prev: Optional[int] = None
        m_last = plan.temporal.m_warmup - 1   # warmup publish (-1 = boot)
        cur: Optional[int] = None
        fill = False
        seq_hops = 0
        for ev in ir.lower(plan.temporal, plan.patches, self.policy,
                           stages=self.stages if staged else None,
                           seq_shards=self.seq):
            if isinstance(ev, ir.StageShift):
                fill = True
            elif isinstance(ev, ir.SeqShard):
                seq_hops = ev.hops
            elif isinstance(ev, ir.ComputeInterval):
                cur = ev.fine_step
            elif isinstance(ev, ir.Exchange):
                self._interval_info[cur] = (read_factor, ev.kind, fill,
                                            seq_hops)
                fill = False
                seq_hops = 0
                if ev.kind == "full":
                    m_prev, m_last = m_last, ev.fine_step
                    read_factor = 0.0
                elif ev.kind == "skip":
                    read_factor = 0.0            # stale reuse
                elif ev.kind == "predict":
                    read_factor = (buf_lib.extrapolation_factor(
                        m_prev, m_last, ev.fine_step)
                        if m_prev is not None else 0.0)
        # last-but-one published K/V per lane (predictive extrapolation
        # base): these double the per-slot staged-KV footprint and cost a
        # copy per full boundary, so only materialize them when some
        # boundary actually extrapolates — never for staged steppers, whose
        # displaced contexts subsume prediction (extrapolated buffers would
        # never be attended)
        self._track_prev = (not staged
                            and any(info[0] for info in
                                    self._interval_info.values()))
        if self._track_prev and self._prev_k is None:
            self._prev_k = torch.zeros_like(self._pub_k)
            self._prev_v = torch.zeros_like(self._pub_v)
        if self._track_prev and self._gk is not None and self._prev_gk is None:
            self._prev_gk = torch.zeros_like(self._gk)
            self._prev_gv = torch.zeros_like(self._gv)
        # per-lane comm sizing: taken from the same trace builder the
        # simulate backend replays, so serving cost accounting cannot
        # diverge from simulate_trace's
        trace = sim.build_trace(plan.temporal, plan.patches, cfg, batch=1,
                                stages=self.stages)
        self._latent_bytes = trace.latent_bytes
        self._kv_bytes = trace.kv_bytes_per_worker
        self._act_row_bytes = trace.act_row_bytes

    # ---------------- submission & admission ----------------

    def submit(self, x_T, cond, *, slo_s: Optional[float] = None,
               uid: Optional[int] = None,
               cfg_scale: Optional[float] = None) -> DiffusionRequest:
        """Queue one request. x_T: [H,W,C] or [1,H,W,C] (video lanes: one
        clip, [F,H,W,C] or [1,F,H,W,C]); cond: int or [1], or with a
        text-conditioned model prompt tokens [L, cond_dim+1] or [1, L,
        cond_dim+1].

        cfg_scale > 0 makes this a GUIDED request (classifier-free
        guidance, DESIGN.md §12); None inherits the pipeline config's
        cfg_scale (0 = unguided). CFG and non-CFG requests mix freely —
        guidance state is per lane. A video clip runs the plan's fused
        guidance, whose scale a request cannot change.
        """
        x_T = torch.as_tensor(x_T)
        if self.frames is not None:
            self._check_clip(x_T, cfg_scale)
            if x_T.dim() == 4:
                x_T = x_T[None]
        elif x_T.dim() == 3:
            x_T = x_T[None]
        if x_T.shape[0] != 1:
            raise ValueError("one request = one image; got batch "
                             f"{x_T.shape[0]} (submit per image)")
        cond = self._check_cond(cond)
        if uid is None:
            uid, self._next_uid = self._next_uid, self._next_uid + 1
        else:
            self._next_uid = max(self._next_uid, uid + 1)
        if cfg_scale is None:
            cfg_scale = self.default_scale
        req = DiffusionRequest(uid=uid, x_T=x_T.to(self.device), cond=cond,
                               slo_s=slo_s, cfg_scale=cfg_scale)
        if req.guided and self.frames is None:
            if not self.stepper.supports_guidance:
                raise ValueError(
                    f"backend {self.pipeline.config.backend!r} has no "
                    "guided serving stepper (guided requests need "
                    "'emulated' or single-stage 'pipefuse')")
            if self._gk is None:
                self._gk = torch.zeros(self._kshape2, dtype=self._kdt,
                                       device=self.device)
                self._gv = torch.zeros_like(self._gk)
                if self._track_prev:
                    self._prev_gk = torch.zeros_like(self._gk)
                    self._prev_gv = torch.zeros_like(self._gk)
        req.submit_round = len(self.rounds)
        req.submit_clock_s = self.modeled_clock_s
        req._submit_wall = time.perf_counter()
        self.queue.append(req)
        return req

    def _check_cond(self, cond) -> torch.Tensor:
        """A request's cond on the lanes' device, checked with the
        reference's messages: prompt tokens [1, L, cond_dim+1] on a
        text-conditioned model, a class id [1] otherwise."""
        cond = torch.as_tensor(cond)
        if not self._prompt_mode:
            if cond.dim() >= 2:
                raise ValueError(
                    "prompt-token cond needs a text-conditioned model "
                    "(DiTConfig.cross_attn=True, e.g. "
                    "cfg.text_conditioned()); this engine serves class-"
                    "conditional requests")
            return cond.to(device=self.device, dtype=torch.int32).reshape(1)
        if cond.dim() == 2:
            cond = cond[None]
        if cond.dim() != 3 or cond.shape[0] != 1:
            raise ValueError(
                "a text-conditioned model takes prompt tokens "
                "[L, cond_dim+1] or [1, L, cond_dim+1] (see "
                "repro_torch.models.text_encoder.encode), got shape "
                f"{tuple(cond.shape)}")
        mcfg = self.pipeline.model_cfg
        if cond.shape[-1] != mcfg.cond_dim + 1:
            raise ValueError(
                f"prompt tokens carry cond_dim+1={mcfg.cond_dim + 1} "
                f"channels (features + validity mask), got {cond.shape[-1]}")
        if not 1 <= cond.shape[1] <= mcfg.cond_seq_len:
            raise ValueError(
                f"prompt bucket {cond.shape[1]} is outside "
                f"[1, cond_seq_len={mcfg.cond_seq_len}]")
        if getattr(self.stepper, "wants_ctx", False):
            pipefuse_lib.refuse_prompt(cond, "the staged pipefuse stepper")
        return cond.to(device=self.device, dtype=torch.float32)

    def _check_clip(self, x_T, cfg_scale) -> None:
        """A video lane's submit checks, with the reference's messages."""
        clip = x_T[None] if x_T.dim() == 4 else x_T
        if clip.dim() != 5 or clip.shape[0] != 1:
            raise ValueError(
                "one request = one clip; video lanes take [F,H,W,C] "
                f"or [1,F,H,W,C], got shape {tuple(x_T.shape)}")
        if clip.shape[1] != self.frames.num_frames:
            raise ValueError(
                f"request carries {clip.shape[1]} frames, the plan "
                f"serves {self.frames.num_frames}")
        if cfg_scale is not None and cfg_scale > 0:
            gplan = self.plan.guidance
            if gplan is None:
                raise ValueError(
                    "guided video lanes run the plan's fused CFG: "
                    "plan with cfg_scale > 0 (e.g. "
                    "planner='stadi_video') instead of a per-request "
                    "scale")
            if float(cfg_scale) != float(gplan.scale):
                raise ValueError(
                    "video lanes run whole-clip schedules through the "
                    f"planned executor: per-request cfg_scale="
                    f"{cfg_scale} cannot override the plan's fused "
                    f"scale {gplan.scale}")

    def _admit(self, report: RoundReport) -> None:
        M_w = self.plan.temporal.m_warmup
        params, cfg = self.pipeline.params, self.pipeline.model_cfg
        while self.queue and len(self.active) < self.slots:
            req = self.queue.pop(0)
            slot = next(s for s in range(self.slots) if s not in self.active)
            self._x[slot] = req.x_T[0]
            if not self._prompt_mode:    # prompt tokens stay on the request
                self._cond[slot] = req.cond[0]
            self._scales[slot] = req.cfg_scale if req.guided else 0.0
            req.fine_step = 0
            req.admit_round = report.index
            if M_w == 0:
                # run_schedule's buffer bootstrap: one full forward at ts[0]
                # (only its K/V is kept, so a guided one needs no combine)
                x = self._x[slot:slot + 1]
                t0 = int(self._ts[0])
                self.dispatches["bootstrap"] += 1
                if req.guided:
                    _, (k2, v2) = dit.forward_patch_cfg(
                        params, cfg, x, t0, req.cond, 0, branch_axis=1)
                    self._gk[:, :, slot] = k2[:, :, 0]
                    self._gv[:, :, slot] = v2[:, :, 0]
                else:
                    _, (k, v) = dit.forward_patch(params, cfg, x, t0,
                                                  req.cond, 0)
                    self._pub_k[:, slot] = k[:, 0]
                    self._pub_v[:, slot] = v[:, 0]
            self.active[slot] = req
            report.admitted.append((req.uid, slot))

    def preempt(self, uid: int) -> bool:
        """Evict an active request back to the FRONT of the queue (it
        restarts from x_T on readmission — diffusion state is cheap to
        recompute relative to holding a slot past an SLO breach). True if
        the request was active; False if it was queued or already done."""
        for slot, req in list(self.active.items()):
            if req.uid == uid:
                del self.active[slot]
                req.fine_step = 0
                req.preempt_count += 1
                self.preemptions += 1
                self.queue.insert(0, req)
                return True
        return False

    # ---------------- online replanning (DESIGN.md §7.1 + §12/§14) -------

    def _feed_profiler(self) -> None:
        """One adaptive round's synthesized per-device interval timings.
        Under split guidance each logical worker feeds BOTH its pair
        devices, so the profiler sees every device's true speed."""
        temporal = self.plan.temporal
        subs = [0] * len(self.plan.patches)
        for i in temporal.active:
            if self.plan.patches[i] > 0:
                subs[i] = temporal.lcm // temporal.ratios[i]
        hetero.feed_profiler(self.profiler, self.cm, subs, self.plan.patches,
                             self.measured_speeds,
                             device_map=self._guide_pairs)

    def _maybe_replan(self) -> None:
        """Drift check at the rebalance cadence: when the profiled speeds
        left the planned ones behind, re-run the configured planner over
        them (re-pairing cond/uncond device groups under split guidance),
        invalidate the now-stale plan-cache entry, and stage the new plan
        for installation at the next grid-aligned round."""
        drift = self.profiler.drift(self._baseline)
        if drift <= self.rebalance_threshold:
            return
        pipe = self.pipeline
        stale_key = pipe.last_plan_key
        new = pipe.plan(self.profiler.speeds)
        if (pipe.plan_cache is not None and stale_key
                and stale_key != pipe.last_plan_key):
            pipe.plan_cache.invalidate(stale_key)
        self._pending_plan = (new, drift)

    def _try_install_pending(self) -> None:
        """Install a staged replan once every active adaptive lane sits on
        the new plan's interval grid (lanes advance plan.lcm fine steps per
        round, so a misaligned cohort retries next round)."""
        new, drift = self._pending_plan
        M_w = self.plan.temporal.m_warmup
        for req in self.active.values():
            if req.fine_step > M_w and (req.fine_step - M_w) % new.temporal.lcm:
                return
        self._pending_plan = None
        fine = min((r.fine_step for r in self.active.values()), default=M_w)
        self.replans.append(ReplanEvent(fine, drift, list(self._baseline),
                                        list(self.profiler.speeds), new))
        self._baseline = list(self.profiler.speeds)
        self._install_plan(new)

    # ---------------- one scheduling round ----------------

    def step(self) -> List[DiffusionRequest]:
        """One round: admit -> warmup group -> adaptive group(s) -> retire."""
        report = RoundReport(index=len(self.rounds))
        wall0 = time.perf_counter()
        if self.frames is not None:
            return self._frames_round(report, wall0)
        if self._pending_plan is not None:
            self._try_install_pending()
        self._admit(report)
        temporal = self.plan.temporal
        M_w, M_base, R = temporal.m_warmup, temporal.m_base, temporal.lcm
        warm = sorted(s for s, r in self.active.items()
                      if r.fine_step < M_w)
        adapt = sorted(s for s, r in self.active.items()
                       if r.fine_step >= M_w)
        report.warmup_lanes, report.adaptive_lanes = warm, adapt

        for guided, bucket, lanes in self._by_guided(warm):
            idx = self._index(lanes)
            fine = torch.tensor([self.active[s].fine_step for s in lanes])
            t_from, t_to = self._ts[fine], self._ts[fine + 1]
            n0 = self._forwards()
            if guided:
                xs, k2s, v2s = self.stepper.warmup_step_guided(
                    self._x[idx], t_from, t_to, self._conds(idx, lanes),
                    self._scales[idx])
                self._x[idx] = xs
                self._put(self._gk, 2, idx, k2s)
                self._put(self._gv, 2, idx, v2s)
            else:
                xs, ks, vs = self.stepper.warmup_step(
                    self._x[idx], t_from, t_to, self._conds(idx, lanes))
                self._scatter(idx, xs, ks, vs)
            self.bucket_dispatches[(guided, bucket)] += self._forwards() - n0
            for s in lanes:
                self.active[s].fine_step += 1
            _, cost = self._phase_cost(len(lanes), warm=True, guided=guided,
                                       cond_tokens=bucket)
            report.modeled_s += cost

        if adapt:
            placement = None
            wants_ctx = getattr(self.stepper, "wants_ctx", False)
            for group, (read_factor, trail_kind, fill, seq_hops,
                        guided, bucket) in self._groups(adapt):
                idx = self._index(group)
                conds = self._conds(idx, group)
                n0 = self._forwards()
                fine = np.asarray([self.active[s].fine_step for s in group])
                merge = trail_kind == "full"
                axis = 2 if guided else 1          # the slot axis of the K/V
                state = ((self._gk, self._gv) if guided
                         else (self._pub_k, self._pub_v))
                prev = ((self._prev_gk, self._prev_gv) if guided
                        else (self._prev_k, self._prev_v))
                bk, bv = (self._take(b, axis, idx, guided) for b in state)
                # predictive boundary before this group (staged steppers
                # never read it: their contexts subsume it)
                if read_factor and not wants_ctx:
                    bk = buf_lib.extrapolate_arrays(
                        bk, self._take(prev[0], axis, idx, False), read_factor)
                    bv = buf_lib.extrapolate_arrays(
                        bv, self._take(prev[1], axis, idx, False), read_factor)
                if merge and self._track_prev:
                    # pre-merge buffers become the extrapolation base (the
                    # merge below may write the state in place)
                    for dst, src in zip(prev, state):
                        self._put(dst, axis, idx, self._take(src, axis, idx,
                                                             False))
                if guided:           # branch-stacked per-lane CFG state
                    xs, ks, vs = self.stepper.interval_guided(
                        self._x[idx], fine, conds, self._scales[idx], bk, bv,
                        merge=merge)
                elif wants_ctx:
                    if fill:         # pipe refill: contexts <- published
                        self._put(self._ctx_k, 1, idx, bk)
                        self._put(self._ctx_v, 1, idx, bv)
                    ck, cv = (self._take(c, 1, idx, False)
                              for c in (self._ctx_k, self._ctx_v))
                    xs, ks, vs, ck, cv = self.stepper.interval_ctx(
                        self._x[idx], fine, conds, bk, bv, ck, cv,
                        merge=merge)
                    self._put(self._ctx_k, 1, idx, ck)
                    self._put(self._ctx_v, 1, idx, cv)
                else:
                    xs, ks, vs = self.stepper.interval(
                        self._x[idx], fine, conds, bk, bv, merge=merge)
                self.bucket_dispatches[(guided, bucket)] += \
                    self._forwards() - n0
                self._x[idx] = xs
                if merge:
                    self._put(state[0], axis, idx, ks)
                    self._put(state[1], axis, idx, vs)
                for s in group:
                    self.active[s].fine_step += R
                placement, cost = self._phase_cost(
                    len(group), warm=False, kind=trail_kind, fill=fill,
                    guided=guided, seq_hops=seq_hops, cond_tokens=bucket)
                report.modeled_s += cost
                report.exchange_kinds.append(trail_kind)
            report.placement = placement
            if self.profiler is not None:
                self._feed_profiler()
                self._rounds_since_check += 1
                if (self._rounds_since_check >= self.rebalance_every
                        and self._pending_plan is None):
                    self._rounds_since_check = 0
                    self._maybe_replan()

        self.modeled_clock_s += report.modeled_s
        done_slots = [s for s, r in sorted(self.active.items())
                      if r.fine_step >= M_base]
        if done_slots and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # flush BEFORE stamping wall
        finished = []
        for slot in done_slots:
            req = self.active.pop(slot)
            req.image = self._x[slot:slot + 1].clone()
            req.done = True
            req.finish_round = report.index
            req.modeled_latency_s = self.modeled_clock_s - req.submit_clock_s
            req.wall_latency_s = time.perf_counter() - req._submit_wall
            finished.append(req)
        self.completed.extend(finished)
        report.wall_s = time.perf_counter() - wall0
        self.rounds.append(report)
        return finished

    def _frames_round(self, report: RoundReport,
                      wall0: float) -> List[DiffusionRequest]:
        """One video round: admit FIFO into free slots, then run every
        admitted clip's whole schedule back to back through the configured
        frame executor. Each clip accrues the frame-priced makespan in turn
        (the cluster serves one clip at a time), so later clips of a round
        see the earlier ones' service as queueing."""
        config = self.pipeline.config
        M_base = self.plan.temporal.m_base
        while self.queue and len(self.active) < self.slots:
            req = self.queue.pop(0)
            slot = next(s for s in range(self.slots) if s not in self.active)
            req.fine_step = 0
            req.admit_round = report.index
            self.active[slot] = req
            report.admitted.append((req.uid, slot))
        executor = get_executor(config.backend)
        finished: List[DiffusionRequest] = []
        for slot in sorted(self.active):
            req = self.active.pop(slot)
            image, _ = executor(
                params=self.pipeline.params,
                model_cfg=self.pipeline.model_cfg,
                sched=self.pipeline.sched, x_T=req.x_T, cond=req.cond,
                plan=self.plan, config=config, interval_hook=None)
            self.dispatches["clip"] += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            report.modeled_s += self._clip_cost_s
            self.modeled_clock_s += self._clip_cost_s
            req.image = image
            req.fine_step = M_base
            req.done = True
            req.finish_round = report.index
            req.modeled_latency_s = self.modeled_clock_s - req.submit_clock_s
            req.wall_latency_s = time.perf_counter() - req._submit_wall
            finished.append(req)
        self.completed.extend(finished)
        report.wall_s = time.perf_counter() - wall0
        self.rounds.append(report)
        return finished

    def run_to_completion(self, max_rounds: int = 100_000
                          ) -> List[DiffusionRequest]:
        done: List[DiffusionRequest] = []
        rounds = 0
        while (self.queue or self.active) and rounds < max_rounds:
            done.extend(self.step())
            rounds += 1
        if self.queue or self.active:
            raise RuntimeError(f"undrained after {max_rounds} rounds")
        return done

    # ---------------- lane plumbing ----------------

    def _index(self, lanes: Sequence[int]) -> LaneIndex:
        """A lane group's index into the slot-major state (the reference's
        ``_pad``, which pads the group to the slot count for stable jit
        shapes; eager dispatches need none, so the group is taken as is): a
        slice for consecutive slots, whose state is then read and written
        in place, else an index tensor on the device."""
        lo = lanes[0]
        if list(lanes) == list(range(lo, lo + len(lanes))):
            return slice(lo, lo + len(lanes))
        return torch.tensor(list(lanes), device=self.device)

    @staticmethod
    def _take(buf, axis: int, idx: LaneIndex, guided: bool):
        """The lane group's part of a state buffer along its slot ``axis``:
        a view for a slice, a gather otherwise. A guided group must fold
        its branch and lane axes into one batch axis without a copy each
        dispatch, so a guided view that cannot is gathered here, once."""
        part = buf[(slice(None),) * axis + (idx,)]
        if guided and not part.is_contiguous():
            part = part.contiguous()
        return part

    @staticmethod
    def _put(buf, axis: int, idx: LaneIndex, value) -> None:
        """Write a lane group's part back into a state buffer (nothing to do
        when ``value`` is that part itself: a view merged in place)."""
        key = (slice(None),) * axis + (idx,)
        if isinstance(idx, slice):
            dst = buf[key]
            if (dst.data_ptr() == value.data_ptr()
                    and dst.stride() == value.stride()):
                return
            dst.copy_(value)
        else:
            buf[key] = value

    def _conds(self, idx: LaneIndex, lanes: Sequence[int]) -> torch.Tensor:
        """Lane-stacked conditioning of a lane group: class ids [G], or the
        requests' prompt tokens [G, L, cond_dim+1] (the group key pins one
        bucket L, so the stack is rectangular)."""
        if not self._prompt_mode:
            return self._cond[idx]
        return torch.cat([self.active[s].cond for s in lanes])

    def _forwards(self) -> int:
        """Denoiser dispatches so far, of every kind."""
        return sum(n for k, n in self.dispatches.items()
                   if not k.endswith("_lanes"))

    def _lane_bucket(self, slot: int) -> int:
        """The lane's prompt bucket (0 for a class lane): tokens of
        different buckets cannot share a stacked dispatch, so the bucket
        joins every lane-group key."""
        return self.active[slot].cond.shape[1] if self._prompt_mode else 0

    def _scatter(self, idx: LaneIndex, xs, ks, vs) -> None:
        self._x[idx] = xs
        self._put(self._pub_k, 1, idx, ks)
        self._put(self._pub_v, 1, idx, vs)

    def _by_guided(self, lanes: List[int]
                   ) -> List[Tuple[bool, int, List[int]]]:
        """Split a lane list into (guided?, bucket, lanes) batches, plain
        first — CFG and non-CFG lanes run different dispatch shapes, and
        prompt lanes of different buckets different cond shapes."""
        keyed: Dict[Tuple[bool, int], List[int]] = {}
        for s in lanes:
            keyed.setdefault((self.active[s].guided,
                              self._lane_bucket(s)), []).append(s)
        return [(g, b, keyed[(g, b)]) for g, b in sorted(keyed)]

    def _groups(self, lanes: List[int]
                ) -> List[Tuple[List[int],
                                Tuple[float, str, bool, int, bool, int]]]:
        """Batchable lane groups + their (read_factor, trail_kind, fill,
        seq_hops, guided, bucket) info. The batching steppers group every
        lane whose boundary behavior, stage-chain fill, seq-shard ring
        identity, guidance state and prompt bucket match (under "sync" with
        no CFG lanes, no seq sharding and one bucket that is ONE group); the
        cohort-only (spmd) stepper groups by fine step and bucket, which
        pins the interval info (it serves no guided lane)."""
        if not self.stepper.cohort_only:
            keyed: Dict[Tuple[float, str, bool, int, bool, int],
                        List[int]] = {}
            for s in lanes:
                keyed.setdefault(self._lane_info(s), []).append(s)
            return [(keyed[k], k) for k in sorted(keyed)]
        cohorts: Dict[Tuple[int, int], List[int]] = {}
        for s in lanes:
            key = (self.active[s].fine_step, self._lane_bucket(s))
            cohorts.setdefault(key, []).append(s)
        return [(cohorts[k], self._lane_info(cohorts[k][0]))
                for k in sorted(cohorts)]

    def _lane_info(self, slot: int
                   ) -> Tuple[float, str, bool, int, bool, int]:
        info = self._interval_info[self.active[slot].fine_step]
        return info + (self.active[slot].guided, self._lane_bucket(slot))

    # ---------------- modeled cost & placement ----------------

    def _phase_cost(self, group: int, warm: bool, kind: str = "full",
                    fill: bool = False, guided: bool = False,
                    seq_hops: int = 0, cond_tokens: int = 0
                    ) -> Tuple[Tuple[Tuple[int, int], ...], float]:
        """Placement + modeled seconds for one batched phase of a round.

        Mirrors ``simulate.simulate_trace`` with compute scaled by the lane
        count: batching multiplies the per-row work but amortizes t_fixed —
        the modeled reason continuous batching beats sequential serving.
        Latent traffic is the per-worker uneven all-gather (padded slabs),
        and "skip"/"predict" boundaries move no bytes at all. With a stage
        chain (DESIGN.md §11) the placement maps STAGES to devices instead
        (:meth:`_staged_phase_cost`). Guided (fused-CFG) phases double the
        per-row work and the staged-K/V payload — both branches ride every
        lane (DESIGN.md §12).
        Sequence-sharded lanes (DESIGN.md §13) run each patch worker on a
        GROUP of ``seq.n_shards`` devices (placement entries map workers to
        groups, speed = group aggregate) and overlap ``seq_hops`` ring K/V
        hops per substep with compute, exactly as in
        ``simulate._simulate_seq``. Prompt lanes add the cross-attention
        read ``t_xattn * cond_tokens`` a row a branch, as ``simulate_trace``
        prices it.
        """
        if self.stages is not None and len(self.stages) > 1:
            return self._staged_phase_cost(group, warm, kind, fill,
                                           cond_tokens)
        if guided and self._guide_pairs is not None:
            return self._split_phase_cost(group, warm, kind, cond_tokens)
        plan, cm = self.plan, self.cm
        temporal = plan.temporal
        branch = 2 if guided else 1
        t_row_eff = cm.t_row + cm.t_xattn * cond_tokens
        workers = [i for i in temporal.active if plan.patches[i] > 0]
        loads = {}
        for i in workers:
            sub = 1 if warm else temporal.lcm // temporal.ratios[i]
            loads[i] = sub * (cm.t_fixed
                              + t_row_eff * plan.patches[i] * group * branch)
        by_load = sorted(workers, key=lambda i: (-loads[i], i))
        speeds = self.measured_speeds
        if self._seq_groups is not None:
            # each worker = one device group; the group's members split the
            # worker's rows/heads, so its serving throughput is the sum
            speeds = [sum(g) for g in self._seq_groups]
        by_speed = sorted(range(len(speeds)), key=lambda d: (-speeds[d], d))
        placement = tuple(sorted((w, d) for w, d in zip(by_load, by_speed)))
        compute = max(loads[w] / max(speeds[d], 1e-9)
                      for w, d in placement)
        ring_t = 0.0
        if self._seq_groups is not None:
            hops = (self.seq.n_shards - 1) if warm else seq_hops
            if hops:
                for w in workers:
                    sub = 1 if warm else temporal.lcm // temporal.ratios[w]
                    ring_t = max(ring_t, sub * hops * (
                        self._kv_bytes[w] * self._seq_seg_pad * group
                        * branch / cm.link_bw + cm.link_latency))
        if (not warm and kind != "full") or len(workers) <= 1:
            # stale/predict (or lone worker): no gather, but ring hops
            # still serialize against compute
            return placement, max(compute, ring_t)
        rows_total = max(sum(plan.patches), 1)
        row_bytes = self._latent_bytes / rows_total
        gather_rows = comm_lib.uneven_all_gather_rows(
            [plan.patches[i] for i in workers])
        comm_bytes = gather_rows * row_bytes * group
        if warm:
            comm_bytes += sum(self._kv_bytes[w] for w in workers) \
                * group * branch
            async_t = 0.0
        else:
            async_t = max(self._kv_bytes[w] for w, _ in placement) \
                * group * branch / cm.link_bw
        comm = comm_bytes / cm.link_bw + cm.link_latency
        return placement, max(compute, async_t, ring_t) + comm

    def _split_phase_cost(self, group: int, warm: bool, kind: str = "full",
                          cond_tokens: int = 0
                          ) -> Tuple[Tuple[Tuple[int, int], ...], float]:
        """Split-guidance group placement + modeled seconds (DESIGN.md
        §12/§14): logical worker i runs BOTH branches concurrently on its
        (cond, uncond) device pair — per-row work is NOT doubled but the
        pair moves at its slower member — and every substep exchanges the
        two branches' epsilons across the pair link before the CFG combine.
        Mirrors ``planners._guided_plan_cost``'s fresh split interval (the
        planner's scoring and the engine's accounting cannot diverge);
        batching scales row work and wire bytes by the lane count.
        Placement entries are (worker, cond_device) — the pairing is the
        plan's, not a per-round search (re-pairing happens at replans).
        """
        plan, cm, g = self.plan, self.cm, self.plan.guidance
        temporal = plan.temporal
        speeds = self.measured_speeds
        workers = [i for i in temporal.active if plan.patches[i] > 0]
        rows_total = max(sum(plan.patches), 1)
        row_bytes = self._latent_bytes / rows_total
        compute, eps_bytes, hops = 0.0, 0.0, 0
        for i in workers:
            sub = 1 if warm else temporal.lcm // temporal.ratios[i]
            rows = plan.patches[i]
            pair_v = min(speeds[g.cond_devices[i]],
                         speeds[g.uncond_devices[i]])
            step_t = cm.t_fixed + (cm.t_row + cm.t_xattn * cond_tokens) \
                * rows * group
            compute = max(compute, sub * step_t / max(pair_v, 1e-9))
            eps_bytes += 2 * sub * rows * row_bytes * group
            hops = max(hops, sub)
        eps_t = eps_bytes / cm.link_bw + hops * cm.link_latency
        placement = tuple(sorted((i, g.cond_devices[i]) for i in workers))
        if (not warm and kind != "full") or len(workers) <= 1:
            return placement, compute + eps_t
        gather_rows = comm_lib.uneven_all_gather_rows(
            [plan.patches[i] for i in workers])
        comm_bytes = gather_rows * row_bytes * group
        if warm:
            # branch factor 1: each branch's staged K/V stays inside its
            # own device group, the two groups broadcast concurrently
            comm_bytes += sum(self._kv_bytes[w] for w in workers) * group
            async_t = 0.0
        else:
            async_t = max(self._kv_bytes[w] for w in workers) \
                * group / cm.link_bw
        comm = comm_bytes / cm.link_bw + cm.link_latency
        return placement, max(compute, async_t) + comm + eps_t

    def _staged_phase_cost(self, group: int, warm: bool, kind: str,
                           fill: bool, cond_tokens: int = 0
                           ) -> Tuple[Tuple[Tuple[int, int], ...], float]:
        """Stage-chain placement + modeled seconds (DESIGN.md §11): stage d
        (chain order) runs on the d-th fastest device; micro-batches stream
        through the chain, so steady state is bound by the slowest stage,
        with point-to-point handoffs, a fill bubble on refill rounds and a
        latent handoff on draining boundaries (the same
        :mod:`repro_torch.core.simulate` helpers the trace replay prices).
        Placement entries are (stage, device). A prompt bucket folds the
        cross-attention read into the row rate, as
        ``simulate._simulate_staged`` does."""
        plan, cm = self.plan, self.cm
        if cond_tokens:
            cm = dataclasses.replace(
                cm, t_row=cm.t_row + cm.t_xattn * cond_tokens)
        temporal = plan.temporal
        S = len(self.stages)
        speeds = self.measured_speeds
        by_speed = sorted(range(len(speeds)), key=lambda d: (-speeds[d], d))
        chain = [speeds[d] for d in by_speed[:S]]
        placement = tuple((s, by_speed[s]) for s in range(S))
        if warm:
            return placement, sim.pipefuse_warmup_seconds(
                self.stages, chain, cm, sum(plan.patches) * group,
                self._act_row_bytes)
        workers = [i for i in temporal.active if plan.patches[i] > 0]
        tasks = [(temporal.lcm // temporal.ratios[i],
                  plan.patches[i] * group) for i in workers]
        return placement, sim.pipefuse_interval_seconds(
            self.stages, chain, cm, tasks, fill, kind,
            self._latent_bytes * group, self._act_row_bytes)

    # ---------------- reporting ----------------

    def stats(self) -> Dict:
        """Aggregate + per-request serving statistics (modeled + wall).
        ``kernels`` holds the CUDA kernel launches since the engine was
        built (empty on the CPU), ``dispatches`` its denoiser dispatches by
        kind and the lanes they carried: K1 runs once a layer of each
        "plain", "guided" and "bootstrap" dispatch, K2 once a layer of each
        "padded" one (this rank's patch forwards of the spmd stepper), K3
        once a guided one, whatever its lane count."""
        done = sorted(self.completed, key=lambda r: r.uid)
        lats = [r.modeled_latency_s for r in done]
        wall = sum(r.wall_s for r in self.rounds)
        slo = [r.slo_met for r in done if r.slo_met is not None]
        cache = self.pipeline.plan_cache
        base = self._launch_base
        return {
            "n_completed": len(done),
            "cost_model": ("configured" if self.cm_calibrated
                           else "default-uncalibrated"),
            "rounds": len(self.rounds),
            "replans": len(self.replans),
            "preemptions": self.preemptions,
            "planner_calls": self.pipeline.planner_calls,
            "plan_cache": cache.stats() if cache is not None else None,
            "kernels": {k: n - base.get(k, 0)
                        for k, n in kops.launch_counts().items()
                        if n != base.get(k, 0)},
            "dispatches": dict(self.dispatches),
            "dispatches_by_bucket": {
                f"{'guided' if g else 'plain'}/{b}": n
                for (g, b), n in sorted(self.bucket_dispatches.items())},
            "modeled_makespan_s": self.modeled_clock_s,
            "wall_s": wall,
            "throughput_modeled_rps": (len(done) / self.modeled_clock_s
                                       if self.modeled_clock_s else 0.0),
            "throughput_wall_rps": len(done) / wall if wall else 0.0,
            "latency_mean_s": float(np.mean(lats)) if lats else 0.0,
            "latency_p95_s": float(np.percentile(lats, 95)) if lats else 0.0,
            "slo_met_frac": (sum(slo) / len(slo)) if slo else None,
            "requests": [{
                "uid": r.uid,
                "queue_rounds": r.queue_rounds,
                "service_rounds": r.finish_round - r.admit_round + 1,
                "modeled_latency_s": r.modeled_latency_s,
                "wall_latency_s": r.wall_latency_s,
                "slo_s": r.slo_s,
                "slo_met": r.slo_met,
                "preemptions": r.preempt_count,
            } for r in done],
        }
