"""Persistent plan cache of the port (reference:
``repro.serving.plan_cache``, DESIGN.md §14).

Planner search is pure — (cluster speeds, model config, workload shape)
fully determine the ExecutionPlan — so serving restarts and repeated
workload shapes should never pay for the same search twice. PlanCache
persists planner outputs as one JSON file per key under a cache directory
(default ``results/plan_cache/``):

    key  = sha256(canonical JSON of {cluster, model, workload})
    file = <cache_dir>/<key>.json   (atomic tmp+rename writes)

The key recipe, the file layout and :data:`CACHE_VERSION` are the
reference's, so an entry written by either package is a hit in the other:
the *cluster signature* rounds profiled speeds to ``speed_decimals``; the
*model* component is a content hash of the DiTConfig (whose repr is the
reference's, field for field); the *workload* component is every
planner-visible knob, the prompt bucket included at its value in this port
(:meth:`repro_torch.core.pipeline.StadiPipeline._workload_key`).

``StadiPipeline.plan()`` consults the cache before any planner search when
``StadiConfig.plan_cache_dir`` is set, and OnlineProfiler drift (the
pipeline rebalance hook or the serving engine's replanner) invalidates the
entry the drifted run was planned from. Corrupted or unreadable entries
fall back to live planning loudly — a warning and a ``corrupt`` counter,
never a crash. Framework-free: json and hashlib.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import warnings
from typing import Dict, Optional, Sequence

from repro_torch.core.frames import FramePlan
from repro_torch.core.guidance import GuidancePlan
from repro_torch.core.planners import ExecutionPlan
from repro_torch.core.schedule import TemporalPlan
from repro_torch.core.seqpar import SeqPlan

#: bump when the serialized plan layout changes — old entries miss cleanly
#: (the reference's version: 2 added the frame axis, 3 the prompt bucket in
#: the workload key)
CACHE_VERSION = 3

DEFAULT_CACHE_DIR = os.path.join("results", "plan_cache")


def plan_to_dict(plan: ExecutionPlan) -> Dict:
    """JSON-ready dict for a fully-populated ExecutionPlan (the reference's
    six-axis layout)."""
    t = plan.temporal
    d = {
        "version": CACHE_VERSION,
        "temporal": {"steps": list(t.steps), "ratios": list(t.ratios),
                     "excluded": list(t.excluded), "m_base": t.m_base,
                     "m_warmup": t.m_warmup},
        "patches": list(plan.patches),
        "planner": plan.planner,
        "speeds": list(plan.speeds),
        "modeled_interval_cost": plan.modeled_interval_cost,
        "stages": None if plan.stages is None else list(plan.stages),
        "guidance": None,
        "seq": None,
        "frames": None,
    }
    if plan.guidance is not None:
        g = plan.guidance
        d["guidance"] = {
            "mode": g.mode, "scale": g.scale,
            "cond_devices": list(g.cond_devices),
            "uncond_devices": list(g.uncond_devices),
            "uncond_refresh": g.uncond_refresh,
            "reuse_workers": (None if g.reuse_workers is None
                              else list(g.reuse_workers)),
        }
    if plan.seq is not None:
        d["seq"] = {"heads": list(plan.seq.heads),
                    "segments": list(plan.seq.segments)}
    if plan.frames is not None:
        d["frames"] = {"num_frames": plan.frames.num_frames,
                       "groups": list(plan.frames.groups)}
    return d


def plan_from_dict(d: Dict) -> ExecutionPlan:
    """Inverse of :func:`plan_to_dict`; raises on any layout mismatch (the
    caller treats that as a corrupt entry)."""
    if d.get("version") != CACHE_VERSION:
        raise ValueError(f"plan-cache entry version {d.get('version')!r} "
                         f"!= {CACHE_VERSION}")
    t = d["temporal"]
    temporal = TemporalPlan(steps=[int(s) for s in t["steps"]],
                            ratios=[int(r) for r in t["ratios"]],
                            excluded=[bool(e) for e in t["excluded"]],
                            m_base=int(t["m_base"]),
                            m_warmup=int(t["m_warmup"]))
    guidance = None
    if d["guidance"] is not None:
        g = d["guidance"]
        guidance = GuidancePlan(
            mode=g["mode"], scale=float(g["scale"]),
            cond_devices=tuple(int(i) for i in g["cond_devices"]),
            uncond_devices=tuple(int(i) for i in g["uncond_devices"]),
            uncond_refresh=int(g["uncond_refresh"]),
            reuse_workers=(None if g["reuse_workers"] is None
                           else tuple(int(i) for i in g["reuse_workers"])))
    seq = None
    if d["seq"] is not None:
        seq = SeqPlan(heads=tuple(int(h) for h in d["seq"]["heads"]),
                      segments=tuple(int(s) for s in d["seq"]["segments"]))
    frames = None
    if d["frames"] is not None:
        frames = FramePlan(num_frames=int(d["frames"]["num_frames"]),
                           groups=tuple(int(g) for g in
                                        d["frames"]["groups"]))
    mic = d["modeled_interval_cost"]
    return ExecutionPlan(temporal=temporal,
                         patches=[int(p) for p in d["patches"]],
                         planner=str(d["planner"]),
                         speeds=[float(v) for v in d["speeds"]],
                         modeled_interval_cost=(None if mic is None
                                                else float(mic)),
                         stages=(None if d["stages"] is None
                                 else [int(s) for s in d["stages"]]),
                         guidance=guidance, seq=seq, frames=frames)


@dataclasses.dataclass
class PlanCache:
    """Disk-backed planner-output cache with hit/miss/invalidation stats."""

    cache_dir: str = DEFAULT_CACHE_DIR
    #: profiled speeds are rounded to this many decimals in the cluster
    #: signature, so sub-threshold measurement jitter shares one entry
    speed_decimals: int = 2

    hits: int = 0
    misses: int = 0
    invalidations: int = 0
    corrupt: int = 0

    def signature(self, speeds: Sequence[float], model_key: str,
                  workload: Dict) -> str:
        """The cache key: sha256 over the canonical JSON of (cluster
        signature from rounded speeds, model config hash, workload shape)."""
        cluster = [round(float(v), self.speed_decimals) for v in speeds]
        payload = {"version": CACHE_VERSION, "cluster": cluster,
                   "model": model_key, "workload": workload}
        blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.json")

    def get(self, key: str) -> Optional[ExecutionPlan]:
        """The cached plan for ``key``, or None (counted as a miss).
        A corrupted entry warns, counts as corrupt + miss, is removed, and
        planning proceeds live — never a crash."""
        path = self._path(key)
        try:
            with open(path) as f:
                raw = f.read()
        except OSError:
            self.misses += 1
            return None
        try:
            plan = plan_from_dict(json.loads(raw))
        except Exception as e:  # corrupt/garbage/stale-layout entry
            self.corrupt += 1
            self.misses += 1
            warnings.warn(f"plan cache entry {path} is unreadable "
                          f"({type(e).__name__}: {e}); falling back to live "
                          "planning", RuntimeWarning, stacklevel=2)
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        self.hits += 1
        return plan

    def put(self, key: str, plan: ExecutionPlan) -> None:
        """Persist atomically (tmp file + rename) so a crashed writer can
        never leave a half-written entry behind."""
        os.makedirs(self.cache_dir, exist_ok=True)
        blob = json.dumps(plan_to_dict(plan), sort_keys=True)
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def invalidate(self, key: str) -> bool:
        """Drop ``key`` (profiled speeds drifted past the threshold, so the
        persisted plan no longer matches the cluster). True if an entry was
        actually removed."""
        try:
            os.remove(self._path(key))
        except OSError:
            return False
        self.invalidations += 1
        return True

    def stats(self) -> Dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations, "corrupt": self.corrupt,
                "hit_rate": (self.hits / total) if total else 0.0}
