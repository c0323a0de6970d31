"""Text-to-image generation on the port: prompt conditioning as a workload
on a heterogeneous cluster (reference: ``examples/text_to_image.py``).

1.  The frozen, seeded text encoder (``models/text_encoder.py``) maps a
    prompt to ``[1, L, cond_dim+1]`` tokens (the last channel a validity
    mask, L the power-of-two length bucket).
2.  ``DiTConfig.text_conditioned()`` adds cross-attention to the DiT; the
    cond tensor's shape selects the path.
3.  Classifier-free guidance composes: the null branch is the all-zero
    token tensor (``dit.null_like``).
4.  Prompts are a serving axis: requests of different lengths land in
    different buckets, and each served image is held to a lone
    ``pipe.generate`` of the same prompt (within 1e-3: a bucket's lanes
    are one batched forward).

Runs on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/text_to_image_torch.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.pipeline import StadiConfig, StadiPipeline, resolve_device
from repro_torch.models import text_encoder
from repro_torch.models.diffusion import dit
from repro_torch.serving import DiffusionServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", default="a red fox in the snow")
    ap.add_argument("--occupancies", default="0.0,0.5")
    ap.add_argument("--cfg-scale", type=float, default=3.0)
    ap.add_argument("--cond-seq-len", type=int, default=16)
    ap.add_argument("--m-base", type=int, default=8)
    ap.add_argument("--m-warmup", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1) a text-conditioned DiT: one config call adds cross-attention
    cfg = get_config("tiny-dit").reduced().text_conditioned(
        cond_seq_len=args.cond_seq_len)
    params = dit.nondegenerate_params(
        dit.init_params(torch.Generator(dev).manual_seed(0), cfg),
        torch.Generator(dev).manual_seed(101))
    sched = sampler_lib.linear_schedule(T=1000)
    occ = [float(x) for x in args.occupancies.split(",")]

    tokens = text_encoder.encode([args.prompt], cfg, device=dev)
    n_real = int(tokens[0, :, -1].sum())
    print(f"prompt {args.prompt!r} -> {n_real} tokens in bucket "
          f"{tokens.shape[1]} (of {cfg.cond_seq_len}), dim {cfg.cond_dim}")
    x_T = torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                      generator=torch.Generator(dev).manual_seed(1), device=dev)

    # 2) unguided text-to-image on the heterogeneous schedule
    config = StadiConfig.from_occupancies(occ, m_base=args.m_base,
                                          m_warmup=args.m_warmup)
    pipe = StadiPipeline(cfg, params, sched, config, device=dev)
    plan = pipe.plan()
    print(f"cluster speeds {config.speeds}: steps {plan.temporal.steps} "
          f"ratios {plan.temporal.ratios} patches {plan.patches}")
    img = pipe.generate(x_T, tokens).image
    print(f"text-to-image {tuple(img.shape)} finite={bool(torch.isfinite(img).all())}")

    # 3) guided: the null branch is the all-zero token tensor
    gconfig = StadiConfig.from_occupancies(occ, m_base=args.m_base,
                                           m_warmup=args.m_warmup,
                                           cfg_scale=args.cfg_scale)
    gimg = StadiPipeline(cfg, params, sched, gconfig, device=dev).generate(
        x_T, tokens).image
    null = dit.null_like(tokens)
    print(f"CFG scale {args.cfg_scale}: guided image finite="
          f"{bool(torch.isfinite(gimg).all())} (null branch = zero tokens, "
          f"|null| = {float(null.abs().sum()):.0f})")

    # 4) prompts as a serving axis: length-bucketed lane groups
    engine = DiffusionServingEngine(
        StadiPipeline(cfg, params, sched, config, device=dev), slots=4)
    prompts = [args.prompt, "fox", "a very detailed oil painting of a fox "
               "curled beneath a pine tree at dusk", "snow"]
    xs, conds = [], []
    for uid, p in enumerate(prompts):
        xs.append(torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                              generator=torch.Generator(dev).manual_seed(10 + uid),
                              device=dev))
        conds.append(text_encoder.encode([p], cfg, device=dev))
        engine.submit(xs[-1], conds[-1][0])
    done = {r.uid: r for r in engine.run_to_completion()}
    print(f"served {len(done)} prompts across length buckets "
          f"{sorted({c.shape[1] for c in conds})} in "
          f"{engine.stats()['rounds']} rounds")
    worst = 0.0
    for uid in range(len(prompts)):
        ref = pipe.generate(xs[uid], conds[uid]).image
        err = float((done[uid].image - ref).abs().max())
        worst = max(worst, err)
        print(f"  req {uid} (bucket {conds[uid].shape[1]}): max |diff| vs "
              f"generate {err:.2e}")
        # two prompts of one bucket share a batched forward, whose GEMMs
        # round otherwise than a lone forward's on the CPU
        assert err <= 1e-3
    return worst


if __name__ == "__main__":
    main()
