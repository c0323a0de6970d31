"""Three-term roofline of a step on H100s (reference:
``repro.launch.roofline``).

  compute term    = flops_per_device / 989e12          (bf16 dense peak)
  memory term     = bytes_per_device / 3.35e12         (HBM3)
  collective term = collective_bytes_per_device / 50e9 (launch/mesh.LINK_BW)

The compute and memory terms come from the analytic model
(``launch/analytic.py``) divided by the chip count: the idealized
perfectly-sharded bound. The collective term sums the collectives the
dry-run recorded on one rank (``launch/dryrun.py``): each record's kind and
input bytes. The reference parses the same sums out of XLA's HLO text;
:func:`collective_bytes` returns them under the reference's keys, so the
two reports share one schema. The traced FLOPs stay beside them as the
compiler-side view (``raw_hlo_flops``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(records: Iterable[Mapping]) -> Dict:
    """Sum input bytes and counts per collective kind over ``records``
    (dicts with ``kind``, one of the reference's HLO names, ``bytes``, the
    input bytes of the ``count`` collectives it stands for, 1 when absent).
    Keys: each kind, ``total`` and ``_counts``."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for r in records:
        out[r["kind"]] += int(r["bytes"])
        counts[r["kind"]] += r.get("count", 1)
    out["_counts"] = counts
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float               # analytic (matmul-exact) / chips
    bytes_per_device: float               # analytic one-pass HBM model / chips
    collective_bytes_per_device: float    # the dry-run's recorded collectives
    model_flops: float                    # 6*N(active)*D tokens-based, global
    compute_s: float
    memory_s: float
    collective_s: float
    raw_hlo_flops: float = 0.0            # traced FLOPs of one rank
    raw_hlo_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "dominant": self.dominant, "useful_ratio": self.useful_ratio}


def model_flops_for(arch: str, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed. ``shape``
    a ``SHAPES`` name or a ``ShapeSpec``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import encdec as encdec_lib

    cfg = get_config(arch)
    s = SHAPES[shape] if isinstance(shape, str) else shape
    n_active = cfg.active_param_count()
    if s.kind == "train":
        tokens = s.batch * s.seq
        if cfg.family == "encdec":
            tokens = s.batch * (s.seq + encdec_lib.tgt_len_for(s.seq))
        return 6.0 * n_active * tokens
    if s.kind == "prefill":
        tokens = s.batch * s.seq
        if cfg.family == "encdec":
            tokens = s.batch * (s.seq + encdec_lib.tgt_len_for(s.seq))
        return 2.0 * n_active * tokens
    return 2.0 * n_active * s.batch          # decode: one token per request


def build(arch: str, shape, mesh_name: str, chips: int,
          cost: Dict, coll: Dict, flash: bool = False) -> Roofline:
    """Roofline terms: compute/memory from the analytic model divided by
    chips; collective from the dry-run's records on one rank. The traced
    numbers (``cost``: ``flops``, ``bytes accessed``) are kept alongside."""
    from repro_torch.launch import analytic

    per_dev = analytic.per_device(arch, shape, chips, flash=flash)
    cb = float(coll.get("total", 0))
    return Roofline(
        arch=arch, shape=shape if isinstance(shape, str) else shape.name,
        mesh=mesh_name, chips=chips,
        flops_per_device=per_dev.flops, bytes_per_device=per_dev.bytes,
        collective_bytes_per_device=cb,
        model_flops=model_flops_for(arch, shape),
        compute_s=per_dev.flops / PEAK_FLOPS_BF16,
        memory_s=per_dev.bytes / HBM_BW,
        collective_s=cb / LINK_BW,
        raw_hlo_flops=float(cost.get("flops", 0.0) or 0.0),
        raw_hlo_bytes=float(cost.get("bytes accessed", 0.0) or 0.0),
    )
