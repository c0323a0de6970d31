"""Serving entry point of the port, the LLM mode (reference:
``repro.launch.serve``): batched requests of random prompts through the
:class:`~repro_torch.serving.ServingEngine`, on the GPU unless ``--device
cpu`` is given. Weights are random (seeded), as in the reference's; the
model is the ``reduced()`` form, as there.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --requests 8 --device cpu

The diffusion mode (``--diffusion`` and its flags) comes with ROADMAP.md
queue 1 item 9.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

_DIFFUSION = "the serving slice (ROADMAP.md queue 1 item 9)"
#: the reference's diffusion-only flags
_DIFFUSION_FLAGS = ("--occupancies", "--planner", "--backend", "--m-base",
                    "--m-warmup", "--slo-ms", "--exchange", "--exchange-refresh",
                    "--num-stages", "--cfg-scale", "--plan-cache",
                    "--seq-shards", "--num-frames", "--frame-groups",
                    "--prompt", "--cond-tokens", "--cond-seq-len")


def serve(arch: str, *, n_requests: int = 8, slots: int = 4,
          prompt_len: int = 16, max_new: int = 12, reduced: bool = True,
          window: int = 0, seed: int = 0, device=None):
    """Serve ``n_requests`` random prompts; returns the finished requests.
    ``device`` defaults to ``cuda``."""
    from repro_torch.core.pipeline import resolve_device

    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    engine = ServingEngine(model, params, slots=slots,
                           max_len=prompt_len + max_new + 8,
                           window=window or cfg.sliding_window)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for uid in range(n_requests):
        prompt = rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    done = engine.run_to_completion()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)}/{n_requests} requests, {tok} tokens in "
          f"{dt:.2f}s ({tok/dt:.1f} tok/s) on {device}")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b",
                    help="the port serves hymba-1.5b (the reference's "
                         "default, gemma-2b, comes with queue 1 item 15b)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--diffusion", action="store_true",
                    help=f"diffusion serving: comes with {_DIFFUSION}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.diffusion or any(tok.split("=", 1)[0] in _DIFFUSION_FLAGS
                             for tok in rest):
        raise NotImplementedError(f"diffusion serving comes with {_DIFFUSION}")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return serve(args.arch, n_requests=args.requests, slots=args.slots,
                 prompt_len=args.prompt_len, max_new=args.max_new,
                 device=args.device)


if __name__ == "__main__":
    main()
