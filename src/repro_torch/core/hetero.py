"""Heterogeneity modeling: device profiles, effective speeds, occupancy
simulation (paper §V-A "Occupancy Simulation"), depth partitioning and
online re-profiling (DESIGN.md §7.1) — the port's copy of
``repro.core.hetero`` (pure Python but for :func:`profile_step_time`, whose
clock waits for the card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.schedule import effective_speed


@dataclasses.dataclass
class DeviceProfile:
    """One (possibly virtual) accelerator.

    c: relative capability, fastest == 1.0 (offline benchmark, paper §III-B)
    rho: background occupancy in [0, 1] (system API / simulated)
    """
    name: str
    c: float = 1.0
    rho: float = 0.0

    @property
    def v(self) -> float:
        return effective_speed(self.c, self.rho)


def make_cluster(occupancies: Sequence[float],
                 capabilities: Optional[Sequence[float]] = None) -> List[DeviceProfile]:
    """Paper's experimental grid: homogeneous GPUs + per-device occupancy,
    e.g. [0.0, 0.6]; optionally heterogeneous capabilities too."""
    caps = capabilities or [1.0] * len(occupancies)
    return [DeviceProfile(f"dev{i}", c, r)
            for i, (c, r) in enumerate(zip(caps, occupancies))]


def speeds(cluster: Sequence[DeviceProfile]) -> List[float]:
    return [d.v for d in cluster]


# ----------------------------------------------------------------------
# depth partitioning (displaced patch pipeline, DESIGN.md §11)
# ----------------------------------------------------------------------

def stage_partition(n_blocks: int, speeds: Sequence[float]) -> List[int]:
    """Blocks per pipeline stage, proportional to each stage device's speed.

    The depth analogue of Eq. 5's patch allocator: stage ``s`` (chain order;
    callers place the chain on devices in this order) gets
    ``n_blocks * v_s / sum(v)`` contiguous DiT blocks, integerized by
    largest-remainder rounding with every stage keeping at least one block.
    ``len(speeds) == 1`` degenerates to the whole model on one device.
    """
    if n_blocks < 1:
        raise ValueError(f"need at least one block, got {n_blocks}")
    if not speeds:
        raise ValueError("need at least one stage device")
    if any(v <= 0 for v in speeds):
        raise ValueError(f"stage speeds must be positive, got {list(speeds)}")
    s = len(speeds)
    if s > n_blocks:
        raise ValueError(f"{s} stages cannot split {n_blocks} blocks")
    total = sum(speeds)
    ideal = [n_blocks * v / total for v in speeds]
    base = [max(1, int(x)) for x in ideal]
    rem = n_blocks - sum(base)
    order = sorted(range(s), key=lambda i: ideal[i] - base[i], reverse=True)
    for i in order:
        if rem <= 0:
            break
        base[i] += 1
        rem -= 1
    # the >=1 floor may have overshot: shrink the stages furthest above
    # their ideal share, never dropping below one block
    while rem < 0:
        j = max((j for j in range(s) if base[j] > 1),
                key=lambda j: base[j] - ideal[j])
        base[j] -= 1
        rem += 1
    assert sum(base) == n_blocks, (base, n_blocks)
    return base


# ----------------------------------------------------------------------
# profiling
# ----------------------------------------------------------------------

def profile_step_time(step_fn: Callable[[], None], warmup: int = 1,
                      iters: int = 3) -> float:
    """Wall-clock seconds of a single-step callable (used to calibrate the
    simulator's :class:`~repro_torch.core.simulate.CostModel`).

    On the card a call returns once its kernels are queued, so a clock read
    right after it times the host alone. The step's device is learned from
    the process: a step that ran on a CUDA device initialised CUDA (during
    the warm-up at the latest), so when ``torch.cuda.is_initialized()`` is
    true after the warm-up, the current CUDA device is synchronized before
    each clock read; a CPU-only process reads the clock as it is."""
    for _ in range(warmup):
        step_fn()
    sync = (torch.cuda.synchronize if torch.cuda.is_initialized()
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn()
    sync()
    return (time.perf_counter() - t0) / iters


class OnlineProfiler:
    """Beyond-paper: EWMA re-estimation of v_i from measured per-interval
    latencies during inference; feeds re-allocation when drift > threshold.
    The paper profiles once, offline ("derived directly from historical
    inference time profiles") — this adapts to occupancy drift mid-request.
    """

    def __init__(self, init_speeds: Sequence[float], alpha: float = 0.5):
        self.speeds = list(init_speeds)
        self.alpha = alpha

    def update(self, device: int, work: float, measured_time: float) -> float:
        """work = nominal work units completed (e.g. patch_frac * steps)."""
        if measured_time <= 0:
            return self.speeds[device]
        observed_v = work / measured_time
        s = self.speeds[device]
        self.speeds[device] = (1 - self.alpha) * s + self.alpha * observed_v
        return self.speeds[device]

    def drift(self, init_speeds: Sequence[float]) -> float:
        return max(abs(s - s0) / max(s0, 1e-9)
                   for s, s0 in zip(self.speeds, init_speeds))


def feed_profiler(profiler: OnlineProfiler, cm, substeps: Sequence[int],
                  patches: Sequence[int], true_speeds: Sequence[float],
                  device_map: Optional[Sequence[Sequence[int]]] = None
                  ) -> None:
    """Synthesize one interval's measured per-device latencies and feed them
    through the profiler's EWMA — the single-host emulation of per-interval
    timers used by both the pipeline rebalance hook and the serving engine.

    Worker i did ``substeps[i]`` substeps over ``patches[i]`` rows; its
    nominal work (seconds at v=1, via the cost model) divided by the latency
    at the ground-truth speed makes ``observed_v`` converge on that speed.
    device_map[i] lists the devices worker i occupies (a cond/uncond pair
    under split guidance); default is the identity worker->device mapping.
    """
    for i, (sub, rows) in enumerate(zip(substeps, patches)):
        if sub == 0 or rows == 0:
            continue
        work = sub * (cm.t_fixed + cm.t_row * rows)
        devices = (device_map[i] if device_map is not None else (i,))
        for d in devices:
            profiler.update(d, work, work / max(true_speeds[d], 1e-9))
