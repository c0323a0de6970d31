"""LM training driver of the port (reference: ``repro.launch.train``):
``--arch <id> [--full] --steps N``.

The reference's flags and defaults (gemma-2b, 50 steps, batch 4, seq 64,
the ``reduced()`` config unless ``--full``, lr 1e-3, ``--ckpt-dir``): the
synthetic Markov token stream (:class:`repro_torch.data.TokenStream`, the
reference's tokens), the model's ``loss`` and its gradients, AdamW at the
cosine schedule with ``min(20, steps // 10)`` warm-up steps, and a
checkpoint at the end in the reference's format. A VLM's vision embeddings
and an enc-dec model's source frames are drawn from a ``torch.Generator``.
K6 and K7 run in the forward under autograd; their backward
differentiates the plain versions, as the reference differentiates its
plain attention and scan. The reference's device mesh
and sharding rules (``launch/mesh.py``, ``sharding/specs.py``) place
nothing on one device, so the trainer does without them; the dry-run
(``launch/dryrun.py``) runs the same step on a fake production mesh. Runs
on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --steps 10 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.pipeline import resolve_device
from repro_torch.data import TokenStream
from repro_torch.models import build_model, encdec
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_schedule


def make_train_step(model, opt_cfg: adamw.AdamWConfig, total_steps: int):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradients, then one AdamW update at the cosine LR. A
    leaf the loss does not reach gets a zero gradient, as under
    ``jax.grad``. The loss comes back as a 0-d tensor on the device."""
    warmup = min(20, total_steps // 10)

    def train_step(params, opt_state, batch):
        p = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), params)
        flat = tree_lib.leaves(p)
        loss = model.loss(p, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = tree_lib.unflatten(params, [torch.zeros_like(t) if g is None else g
                                            for t, g in zip(flat, grads)])
        lr_scale = cosine_schedule(opt_state["count"], total_steps,
                                   warmup_steps=warmup)
        with torch.no_grad():
            params, opt_state = adamw.adamw_update(params, grads, opt_state,
                                                   opt_cfg, lr_scale)
        return params, opt_state, loss.detach()

    return train_step


def train(arch: str, *, steps: int = 50, batch: int = 4, seq: int = 64,
          reduced: bool = True, lr: float = 1e-3, ckpt_dir: str = None,
          log_every: int = 10, seed: int = 0, device=None, params=None):
    """Train ``arch`` for ``steps`` steps from ``params`` (default: the
    model's ``init`` from ``seed``); returns (params, the losses as
    floats). ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(dev).manual_seed(seed))
    n_params = sum(int(np.prod(t.shape)) for t in tree_lib.leaves(params))
    opt_cfg = adamw.AdamWConfig(lr=lr)
    opt_state = adamw.adamw_init(params)
    step_fn = make_train_step(model, opt_cfg, steps)

    stream = iter(TokenStream(cfg.vocab, seq, batch, seed=seed))
    gen = torch.Generator(dev).manual_seed(seed + 1)
    dt = getattr(torch, cfg.dtype)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        raw = next(stream)
        batch_d = {k: torch.from_numpy(raw[k]).long().to(dev)
                   for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch_d["vision_embeds"] = (torch.randn(
                (batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                device=dev) * 0.02).to(dt)
        if cfg.family == "encdec":
            st = encdec.tgt_len_for(seq)
            batch_d = {"src_embeds": (torch.randn(
                           (batch, seq, cfg.d_model), generator=gen,
                           device=dev) * 0.02).to(dt),
                       "tgt_tokens": batch_d["tokens"][:, :st],
                       "labels": batch_d["labels"][:, :st]}
        params, opt_state, loss = step_fn(params, opt_state, batch_d)
        losses.append(float(loss))
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)",
                  flush=True)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, {"params": params, "opt": opt_state})
    print(f"trained {arch} ({n_params/1e6:.1f}M params) {steps} steps on {dev}: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true", help="full-size config")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                 reduced=not args.full, lr=args.lr, ckpt_dir=args.ckpt_dir,
                 device=args.device)


if __name__ == "__main__":
    main()
