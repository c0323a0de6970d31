"""End-to-end diffusion training entry point — the port of
``examples/train_tiny_diffusion.py`` (it lives in the package, as every
entry point of the port does).

Trains the tiny class-conditional DiT denoiser on the synthetic structured
image dataset for a few hundred steps and checkpoints it: the model every
quality benchmark (Table II analogue) samples from. The same flags and
defaults as the reference: 400 steps, batch 32, lr 2e-3, AdamW with weight
decay 1e-4, the cosine LR with 20 warm-up steps. The forward runs kernel K1
in every block (``dit.block_stack``'s all-fresh read under autograd:
:func:`repro_torch.kernels.ops.stale_kv_attention_autograd`); the backward
differentiates K1's plain version, as the reference differentiates its
plain attend. Runs on the GPU unless ``--device cpu`` is given; ends, as
the reference does, by asserting that the loss fell.

  PYTHONPATH=src python -m repro_torch.launch.train_tiny_diffusion --steps 400
  PYTHONPATH=src python -m repro_torch.launch.train_tiny_diffusion \\
      --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.pipeline import resolve_device
from repro_torch.data import SyntheticImages
from repro_torch.models.diffusion import dit
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_schedule

DEFAULT_CKPT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "results", "tiny_dit_ckpt_torch")
WARMUP_STEPS = 20
WEIGHT_DECAY = 1e-4


def train_step(params, opt_state, x0, cls, gen: torch.Generator,
               cfg: DiTConfig, sched, opt_cfg: adamw.AdamWConfig,
               total_steps: int, draws=None):
    """One step: the diffusion loss of ``dit.forward`` at draws from
    ``gen`` (or at ``draws`` = (t [B], eps), as
    :func:`~repro_torch.core.sampler.diffusion_loss_at` takes them), its
    gradients, one AdamW update at the cosine LR. Returns (params,
    opt_state, loss as a 0-d tensor on the device)."""
    p = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), params)
    eps_fn = lambda x, t: dit.forward(p, cfg, x, t, cls)
    loss = (sampler_lib.diffusion_loss(eps_fn, sched, x0, gen) if draws is None
            else sampler_lib.diffusion_loss_at(eps_fn, sched, x0, *draws))
    grads = tree_lib.unflatten(params, torch.autograd.grad(
        loss, tree_lib.leaves(p)))
    lr_scale = cosine_schedule(opt_state["count"], total_steps,
                               warmup_steps=WARMUP_STEPS)
    with torch.no_grad():
        params, opt_state = adamw.adamw_update(params, grads, opt_state,
                                               opt_cfg, lr_scale)
    return params, opt_state, loss.detach()


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt_state: dict
    losses: List[float]          # one a step
    seconds: float               # wall time of the steps (synchronized)


def train(cfg: DiTConfig, steps: int, batch: int, lr: float, seed: int,
          device, log: Optional[Callable[[str], None]] = print) -> TrainResult:
    """Train ``cfg`` from ``init_params`` on ``SyntheticImages`` of the
    latent's shape; losses are read back once, at the end, and at the
    logged steps (``log`` None: none)."""
    dev = resolve_device(device)
    sched = sampler_lib.linear_schedule(T=1000)
    ds = SyntheticImages(size=cfg.latent_size, channels=cfg.channels,
                         n_classes=cfg.n_classes, seed=seed)
    params = dit.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    opt_cfg = adamw.AdamWConfig(lr=lr, weight_decay=WEIGHT_DECAY)
    opt_state = adamw.adamw_init(params)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    batches = ds.batches(batch, seed=seed + 2)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        imgs, cls = next(batches)
        x0 = torch.from_numpy(imgs).to(dev)
        params, opt_state, loss = train_step(
            params, opt_state, x0, torch.from_numpy(cls).to(dev), gen, cfg,
            sched, opt_cfg, steps)
        losses.append(loss)
        if log is not None and (step % 25 == 0 or step == steps - 1):
            log(f"step {step:4d} loss {float(loss):.4f} "
                f"({(time.perf_counter() - t0) / (step + 1):.3f}s/step)")
    losses = torch.stack(losses).cpu().tolist() if losses else []
    return TrainResult(params, opt_state, losses, time.perf_counter() - t0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    cfg = get_config("tiny-dit")
    n_params = sum(int(np.prod(t.shape)) for t in tree_lib.leaves(
        dit.init_params(torch.Generator().manual_seed(args.seed), cfg)))
    print(f"tiny-dit: {n_params/1e6:.2f}M params, latent {cfg.latent_size}, "
          f"{cfg.n_layers}L d{cfg.d_model}, on {args.device}", flush=True)
    res = train(cfg, args.steps, args.batch, args.lr, args.seed, args.device,
                log=lambda line: print(line, flush=True))
    save_checkpoint(args.ckpt_dir, args.steps, {"params": res.params})
    first, last = res.losses[0], res.losses[-1]
    print(f"done: loss {first:.3f} -> {last:.3f}; "
          f"checkpoint at {args.ckpt_dir}")
    assert last < first, "training must reduce the loss"
    return res


if __name__ == "__main__":
    main()
