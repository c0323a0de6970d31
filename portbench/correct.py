"""How ``correct`` is decided: a sample of what the window produced, drawn
from the seed once the window has closed, held to the plain float32
reference run on the same inputs and weights.

Each sample carries its starting latent, its class or prompt, its guidance
scale and the program's image (and, for a prompt, the program's prompt
tokens). The numbers compared, each against the limit in the cell's file:

- ``plan_mismatch``: 0 when the program's steps and token rows a device
  are the reference's Eq. 4 and Eq. 5, else 1 (limit 0);
- ``image_rel_err``: the largest relative L2 distance of a sampled image
  from the reference's image;
- ``tokens_rel_err``: the largest relative L2 distance of a sampled
  request's prompt tokens from the reference tower's.

The reference runs with TF32 off. The control (``control=True``) puts the
reference itself in the program's place, its products rounded to float8
e4m3 (the tower's to TF32), one step below the precisions the
configuration states.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import dit as ref_dit
from portbench.reference import schedule as ref_schedule
from portbench.reference import tower as ref_tower


@contextlib.contextmanager
def exact_fp32():
    """Float32 products without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def pick(n_done: int, seed: int, count: int, must: Sequence[int] = ()) -> List[int]:
    """``count`` of the ``n_done`` finished outputs, drawn from the seed,
    with the indices in ``must`` (the longest requests) among them."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0x6368]))
    chosen = [i for i in must if 0 <= i < n_done][:count]
    rest = [i for i in rng.permutation(n_done).tolist() if i not in chosen]
    return sorted(chosen + rest[:count - len(chosen)])


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def readings(spec: Dict, params, samples: List[Dict], program_plan,
             device, control: bool = False):
    """The numbers compared for ``samples`` (see the module docstring):
    the program's, and with ``control`` also the control's on the same
    samples, as (program, control or None)."""
    model = spec["config_spec"]["model"]
    sched = spec["config_spec"]["schedule"]
    plan = spec["plan"]
    fp8, tf32 = ref_dit.Precision("fp8"), ref_dit.Precision("tf32")
    prog, ctrl = {}, ({} if control else None)
    with exact_fp32(), torch.no_grad():
        P = ref_dit.fp32_params(params, device)
        occ = plan["occupancies"]
        steps, _, rows = ref_schedule.plan(occ, plan["m_base"], plan["m_warmup"],
                                           model["latent_size"] // model["patch_size"])
        prog["plan_mismatch"] = float(
            (list(program_plan[0]), list(program_plan[1])) != (steps, rows))
        if control:
            ctrl["plan_mismatch"] = 0.0
        errs = {"prog": ([], []), "ctrl": ([], [])}
        tw = (ref_tower.weights(model["cond_dim"], device)
              if model.get("cross_attn") else None)
        for s in samples:
            x_T = s["x_T"].to(device=device, dtype=torch.float32)
            kw = dict(occupancies=occ, m_base=plan["m_base"],
                      m_warmup=plan["m_warmup"], T=sched["T"],
                      beta_min=sched["beta_min"], beta_max=sched["beta_max"],
                      cfg_scale=s.get("cfg_scale"))
            if s.get("prompt") is not None:
                cond = ref_tower.encode([s["prompt"]], model["cond_dim"],
                                        model["cond_seq_len"], device, W=tw)
                errs["prog"][1].append(rel_err(s["tokens"].to(device), cond))
            else:
                cond = torch.tensor([s["cls"]], device=device)
            want, _ = ref_schedule.sample(P, model, x_T, cond, **kw)
            errs["prog"][0].append(rel_err(s["image"].to(device), want))
            if control:
                c_cond = cond
                if s.get("prompt") is not None:
                    c_cond = ref_tower.encode([s["prompt"]], model["cond_dim"],
                                              model["cond_seq_len"], device,
                                              tf32, W=tw)
                    errs["ctrl"][1].append(rel_err(c_cond, cond))
                got, _ = ref_schedule.sample(P, model, x_T, c_cond, prec=fp8,
                                             **kw)
                errs["ctrl"][0].append(rel_err(got, want))
            if device.type == "cuda":
                torch.cuda.empty_cache()
        for name, out in (("prog", prog), ("ctrl", ctrl)):
            if out is None:
                continue
            img, tok = errs[name]
            out["image_rel_err"] = max(img)
            if tok:
                out["tokens_rel_err"] = max(tok)
    return prog, ctrl


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every reading is within its limit (a missing or
    non-finite reading fails)."""
    return all(k in readings and np.isfinite(readings[k])
               and readings[k] <= v for k, v in limits.items())


def report(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number compared beside its limit, for the result line."""
    return {k: {"value": readings.get(k), "limit": v} for k, v in limits.items()}


def print_report(checks: Dict) -> None:
    """The numbers compared, beside their limits, on standard error."""
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
