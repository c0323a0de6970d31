"""Uniform model API of the port's language models (reference:
``repro.models.api``).

``build_model(cfg)`` returns a :class:`Model` exposing:
  init(gen) -> params
  forward_logits(params, batch) -> logits
  init_cache(batch, max_len, window=0, device=None) -> decode cache
  prefill(params, batch, cache, window=0) -> (last_logits, cache)
  decode_step(params, cache, token, window=0) -> (logits, cache)
  make_batch(gen, batch, seq) -> concrete batch  (smoke tests)

The port runs the ``hybrid`` family (Hymba); the others raise
``NotImplementedError`` naming the slice that brings them, as does ``loss``
(training). ``init_cache`` takes the device its cache lives on; weights and
batches are made on their generator's device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hymba

#: where each family the port does not run yet comes from
_LATER = "ROADMAP.md queue 1 item 15b (the LM substrate after Hymba serving)"


class Model:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "hybrid":
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: it "
                f"comes with {_LATER}")
        self.cfg = cfg
        self.family = cfg.family

    # -- params ---------------------------------------------------------
    def init(self, gen: torch.Generator):
        return hymba.init_params(gen, self.cfg)

    # -- training -------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]):
        raise NotImplementedError(
            "training (loss_fn, optim/, launch/train.py) comes with the "
            f"training slice of {_LATER}")

    def forward_logits(self, params, batch):
        return hymba.forward(params, self.cfg, batch["tokens"])[0]

    # -- serving --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, window: int = 0,
                   device=None):
        return hymba.init_cache(self.cfg, batch, max_len, window=window,
                                device=device)

    def prefill(self, params, batch, cache, *, window: int = 0):
        return hymba.prefill(params, self.cfg, batch["tokens"], cache,
                             window=window)

    def decode_step(self, params, cache, token, *, window: int = 0):
        return hymba.decode_step(params, self.cfg, cache, token, window=window)

    # -- synthetic batches ----------------------------------------------
    def make_batch(self, gen: torch.Generator, batch: int, seq: int) -> Dict[str, Any]:
        tokens = torch.randint(0, self.cfg.vocab, (batch, seq), generator=gen,
                               device=gen.device, dtype=torch.int64)
        return {"tokens": tokens, "labels": tokens}


def build_model(cfg_or_id) -> Model:
    if isinstance(cfg_or_id, str):
        from repro_torch.configs import get_config
        cfg_or_id = get_config(cfg_or_id)
    return Model(cfg_or_id)
