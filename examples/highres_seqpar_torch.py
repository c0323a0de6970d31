"""High-resolution generation with sequence-parallel attention on the port
(reference: ``examples/highres_seqpar.py``): Ulysses head scattering + ring
K/V staging as the fifth dimension of the STADI schedule.

1.  The ``stadi_seq`` planner prices a 2K-class run (sdxl-dit at a 256x256
    latent, an attention-bound cost model, the simulator) with and without
    sequence shards and picks the shard count (``seq_shards=0``).
2.  On tiny-dit it runs the planner's choice, then pins the patch schedule
    and generates at seq_shards 1, 2 and 4: the sequence dimension moves
    WHERE attention runs, not WHAT is computed, so the images agree.
3.  It bounds the staleness of ring-hopped K/V by the refresh interval.

Runs on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/highres_seqpar_torch.py
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import sampler as sampler_lib
from repro_torch.core import seqpar
from repro_torch.core.pipeline import StadiConfig, StadiPipeline, resolve_device
from repro_torch.core.simulate import CostModel
from repro_torch.models.diffusion import dit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--occupancies", default="0.0,0.0,0.5,0.5")
    ap.add_argument("--seq-shards", type=int, default=0,
                    help="0 = let the stadi_seq planner choose")
    ap.add_argument("--cond", type=int, default=7)
    ap.add_argument("--m-base", type=int, default=16)
    ap.add_argument("--m-warmup", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    occ = [float(x) for x in args.occupancies.split(",")]

    # 1) plan the 2K run on the simulator
    cfg2k = get_config("sdxl-dit").replace(latent_size=256)
    cm = CostModel(t_fixed=2e-3, t_row=1e-4, t_ctx=2e-4,
                   link_bw=50e9, link_latency=20e-6)
    base = StadiConfig.from_occupancies(
        occ, m_base=50, m_warmup=4, backend="simulate", cost_model=cm,
        exchange="ring", exchange_refresh=8)
    pure = StadiPipeline(cfg2k, None, None, dataclasses.replace(
        base, planner="stadi"), device=dev).generate()
    auto = StadiPipeline(cfg2k, None, None, dataclasses.replace(
        base, planner="stadi_seq", seq_shards=args.seq_shards),
        device=dev).generate()
    seq = auto.plan.seq
    print(f"2K latent ({cfg2k.tokens_per_side} token rows, "
          f"{cfg2k.n_heads} heads) on cluster speeds {base.speeds}:")
    print(f"  pure patch parallelism : {pure.latency_s:.3f}s modeled "
          f"(patches {pure.plan.patches})")
    if seq is not None:
        groups, _ = seqpar.seq_group_speeds(base.speeds, seq.n_shards)
        print(f"  stadi_seq picked S={seq.n_shards}: heads {list(seq.heads)}, "
              f"ring segments {list(seq.segments)}, worker groups {groups}")
    else:
        print("  stadi_seq kept the pure patch plan (compute-bound)")
    print(f"  sequence-parallel      : {auto.latency_s:.3f}s modeled "
          f"({(1 - auto.latency_s / pure.latency_s) * 100:.1f}% reduction)")

    # 2) real numerics on tiny-dit
    cfg = get_config("tiny-dit").reduced()
    params = dit.nondegenerate_params(
        dit.init_params(torch.Generator(dev).manual_seed(0), cfg),
        torch.Generator(dev).manual_seed(101))
    sched = sampler_lib.linear_schedule(T=1000)
    x_T = torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                      generator=torch.Generator(dev).manual_seed(1), device=dev)
    cond = torch.full((1,), args.cond % cfg.n_classes, dtype=torch.int64,
                      device=dev)
    run_cfg = StadiConfig.from_occupancies(
        occ, m_base=args.m_base, m_warmup=args.m_warmup, planner="stadi_seq",
        seq_shards=args.seq_shards, cost_model=cm, exchange="ring",
        exchange_refresh=4)
    pipe = StadiPipeline(cfg, params, sched, run_cfg, device=dev)
    plan = pipe.plan()
    splan = plan.seq
    print(f"\ntiny-dit run: planner chose seq="
          f"{splan and (list(splan.heads), list(splan.segments))} over "
          f"patches {plan.patches}")
    res = pipe.generate(x_T, cond)
    print(f"generated {tuple(res.image.shape)} "
          f"finite={bool(torch.isfinite(res.image).all())}")

    # shard-count invariance: pin the patch schedule, vary only S
    pin = StadiConfig.from_occupancies(
        occ, m_base=args.m_base, m_warmup=args.m_warmup, exchange="ring",
        exchange_refresh=4)
    pinned = {S: StadiPipeline(cfg, params, sched, dataclasses.replace(
        pin, seq_shards=S), device=dev).generate(x_T, cond).image
        for S in (1, 2, 4)}
    err = max(float((pinned[1] - pinned[S]).abs().max()) for S in (2, 4))
    print(f"shard-count invariance (fixed patch plan, S=1/2/4): max |diff| "
          f"{err:.2e}")
    assert err <= 1e-5

    worst = seqpar.max_hop_staleness(res.trace.events)
    print(f"worst ring-hop K/V staleness: {worst} intervals "
          f"(bound: refresh-1 = {run_cfg.exchange_refresh - 1})")
    assert worst <= run_cfg.exchange_refresh - 1
    return err


if __name__ == "__main__":
    main()
