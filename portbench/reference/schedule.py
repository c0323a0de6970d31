"""Plain STADI schedule: the paper's Eq. 4 and Eq. 5, the DDIM grid and
update, classifier-free guidance, and Algorithm 1's warm-up and stale-K/V
patch intervals, driven over the float32 DiT of :mod:`.dit`.

Eq. 4 (arXiv 2509.04719): with v_max the fastest effective speed, a
device faster than a*v_max takes every fine step (ratio 1), one in
(b*v_max, a*v_max] every second post-warm-up step (ratio 2), and a slower
one none. Eq. 5: token rows in proportion to v_i / M_i, integers by the
largest remainders. Algorithm 1: M_w synchronous full-image steps, then
intervals of lcm(ratios) fine steps in which each device runs its own
substeps on its rows against the keys and values published at the last
boundary, publishes its first substep's, and all are merged at the
boundary (a synchronous exchange).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from . import dit


def temporal_allocation(speeds: Sequence[float], m_base: int, m_warmup: int,
                        a: float = 0.75, b: float = 0.25):
    """Eq. 4 with the paper's two tiers: (steps, ratios)."""
    vmax = max(speeds)
    steps, ratios = [], []
    for v in speeds:
        if v <= b * vmax:
            steps.append(0)
            ratios.append(0)
        elif v > a * vmax:
            steps.append(m_base)
            ratios.append(1)
        else:
            steps.append(m_warmup + (m_base - m_warmup) // 2)
            ratios.append(2)
    return steps, ratios


def spatial_allocation(speeds: Sequence[float], steps: Sequence[int],
                       rows: int) -> List[int]:
    """Eq. 5: rows in proportion to v_i / M_i, at least one a device that
    steps, the rest by the largest remainders."""
    rate = [v / m if m else 0.0 for v, m in zip(speeds, steps)]
    ideal = [r / sum(rate) * rows for r in rate]
    out = [max(int(math.floor(x)), 1) if r > 0 else 0
           for x, r in zip(ideal, rate)]
    order = sorted(range(len(ideal)), key=lambda i: ideal[i] - out[i],
                   reverse=True)
    left = rows - sum(out)
    while left < 0:                  # the floor of one overshot: take back
        j = max((j for j in range(len(out)) if out[j] > 1),
                key=lambda j: out[j] - ideal[j])
        out[j] -= 1
        left += 1
    for i in order:
        if left <= 0:
            break
        if rate[i] > 0:
            out[i] += 1
            left -= 1
    return out


def plan(occupancies: Sequence[float], m_base: int, m_warmup: int,
         rows: int):
    """The schedule of a cluster of equal cards at these background
    occupancies: (steps, ratios, row counts)."""
    speeds = [1.0 - o for o in occupancies]
    steps, ratios = temporal_allocation(speeds, m_base, m_warmup)
    return steps, ratios, spatial_allocation(speeds, steps, rows)


def ddim_timesteps(T: int, M: int) -> List[int]:
    """M + 1 timesteps from T down to 0: T * (1 - i / M) in float32 (1/M
    rounded to float32 first), rounded half to even."""
    s = np.arange(M, dtype=np.float32) * np.float32(1.0 / M)
    t = np.round(np.float32(T) * (np.float32(1.0) - s)).astype(np.int64)
    return [int(v) for v in t] + [0]


def alpha_bar(T: int, beta_min: float, beta_max: float) -> np.ndarray:
    """The linear beta schedule's cumulative products, alpha_bar[0] = 1."""
    betas = np.concatenate([[0.0], np.linspace(beta_min, beta_max, T,
                                               dtype=np.float32)])
    return np.cumprod((1.0 - betas).astype(np.float32), dtype=np.float32)


def ddim_update(ab, x, eps, t_from: int, t_to: int):
    """DDIM (eta 0) from t_from to t_to."""
    a_f, a_t = math.sqrt(ab[t_from]), math.sqrt(ab[t_to])
    s_f, s_t = math.sqrt(1 - ab[t_from]), math.sqrt(1 - ab[t_to])
    return (a_t / a_f) * x - (a_t * s_f / a_f - s_t) * eps


def sample(P, cfg: dict, x_T, cond, *, occupancies, m_base: int,
           m_warmup: int, T: int, beta_min: float, beta_max: float,
           cfg_scale: Optional[float] = None,
           prec: dit.Precision = dit.FP32):
    """One image by Algorithm 1: x_T [1, H, W, C] float32, cond a class id
    [1] or prompt tokens [1, L, Dc+1]; ``cfg_scale`` > 0 guides every
    evaluation (eps_u + w (eps_c - eps_u); the unconditional branch keeps
    keys and values of its own). Returns (x_0, (steps, row counts))."""
    p = cfg["patch_size"]
    rows_total = cfg["latent_size"] // p
    steps, ratios, rows = plan(occupancies, m_base, m_warmup, rows_total)
    ab = alpha_bar(T, beta_min, beta_max)
    ts = ddim_timesteps(T, m_base)
    branches = [cond] + ([dit.null_like(cond)] if cfg_scale else [])

    def evaluate(x, t, row0, published):
        eps, kv = [], []
        for b, c in enumerate(branches):
            e, fresh = dit.forward(P, cfg, x, t, c, row0,
                                   None if published is None else published[b],
                                   prec)
            eps.append(e)
            kv.append(fresh)
        if cfg_scale:
            return eps[1] + cfg_scale * (eps[0] - eps[1]), kv
        return eps[0], kv

    x = x_T.float()
    published = None
    for m in range(m_warmup):
        eps, published = evaluate(x, ts[m], 0, None)
        x = ddim_update(ab, x, eps, ts[m], ts[m + 1])
    if published is None:
        _, published = evaluate(x, ts[0], 0, None)
    workers = [i for i, r in enumerate(ratios) if r and rows[i]]
    lcm = math.lcm(*[ratios[i] for i in workers])
    starts = np.cumsum([0] + rows).tolist()
    side = rows_total
    m0 = m_warmup
    while m0 + lcm <= m_base:
        fresh, slabs = {}, {}
        for i in workers:
            r, row0 = ratios[i], starts[i]
            x_loc = x[:, row0 * p:(row0 + rows[i]) * p]
            for s in range(lcm // r):
                t_from, t_to = ts[m0 + s * r], ts[m0 + (s + 1) * r]
                eps, kv = evaluate(x_loc, t_from, row0, published)
                if s == 0:
                    fresh[i] = kv
                x_loc = ddim_update(ab, x_loc, eps, t_from, t_to)
            slabs[i] = x_loc
        for i in workers:
            x[:, starts[i] * p:(starts[i] + rows[i]) * p] = slabs[i]
        merged = []
        for b in range(len(branches)):
            k, v = (t.clone() for t in published[b])
            for i in sorted(fresh):
                lo = starts[i] * side
                n = fresh[i][b][0].shape[2]
                k[:, :, lo:lo + n] = fresh[i][b][0]
                v[:, :, lo:lo + n] = fresh[i][b][1]
            merged.append((k, v))
        published = merged
        m0 += lcm
    return x, (steps, rows)
