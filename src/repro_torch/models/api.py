"""Uniform model API of the port's language models (reference:
``repro.models.api``).

``build_model(cfg)`` returns a :class:`Model` exposing:
  init(gen) -> params
  forward_logits(params, batch) -> logits
  init_cache(batch, max_len, window=0, device=None) -> decode cache
  prefill(params, batch, cache, window=0) -> (last_logits, cache)
  decode_step(params, cache, token, window=0) -> (logits, cache)
  make_batch(gen, batch, seq) -> concrete batch  (smoke tests)

batch dict keys by family:
  dense/moe/hybrid : tokens, labels
  vlm              : + vision_embeds [B, n_vision_tokens, D]  (stub ViT frontend)

The port runs the ``dense``, ``moe`` and ``vlm`` families (``lm``) and
``hybrid`` (Hymba); ``ssm`` and ``encdec`` raise ``NotImplementedError``
naming the item that brings them, as does ``loss`` (training).
``init_cache`` takes the device its cache lives on; weights and batches are
made on their generator's device. A VLM's windowed cache pins its vision
tokens before the ring (``lm._pinned``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hymba, lm

#: the families the port runs
FAMILIES = ("dense", "moe", "vlm", "hybrid")
#: where the others come from
_LATER = "ROADMAP.md queue 1 item 15c (the xLSTM and enc-dec LMs)"
_TRAINING = "ROADMAP.md queue 1 item 15d (LM training)"


class Model:
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: it "
                f"comes with {_LATER}")
        self.cfg = cfg
        self.family = cfg.family

    # -- params ---------------------------------------------------------
    def init(self, gen: torch.Generator):
        f = hymba.init_params if self.family == "hybrid" else lm.init_params
        return f(gen, self.cfg)

    # -- training -------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]):
        raise NotImplementedError(
            f"training (loss_fn, data/tokens.py, launch/train.py) comes with "
            f"{_TRAINING}")

    def forward_logits(self, params, batch):
        if self.family == "hybrid":
            return hymba.forward(params, self.cfg, batch["tokens"])[0]
        return lm.forward(params, self.cfg, batch["tokens"],
                          vision_embeds=batch.get("vision_embeds"))[0]

    # -- serving --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, window: int = 0,
                   device=None):
        if self.family == "hybrid":
            return hymba.init_cache(self.cfg, batch, max_len, window=window,
                                    device=device)
        return lm.init_cache(self.cfg, batch, max_len, window=window,
                             device=device)

    def prefill(self, params, batch, cache, *, window: int = 0):
        if self.family == "hybrid":
            return hymba.prefill(params, self.cfg, batch["tokens"], cache,
                                 window=window)
        # a VLM's vision embeddings are consumed here; the cache covers them
        return lm.prefill(params, self.cfg, batch["tokens"], cache,
                          vision_embeds=batch["vision_embeds"]
                          if self.family == "vlm" else None,
                          window=window)

    def decode_step(self, params, cache, token, *, window: int = 0):
        if self.family == "hybrid":
            return hymba.decode_step(params, self.cfg, cache, token,
                                     window=window)
        return lm.decode_step(params, self.cfg, cache, token, window=window)

    # -- synthetic batches ----------------------------------------------
    def make_batch(self, gen: torch.Generator, batch: int, seq: int) -> Dict[str, Any]:
        cfg = self.cfg
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                               device=gen.device, dtype=torch.int64)
        out: Dict[str, Any] = {"tokens": tokens, "labels": tokens}
        if self.family == "vlm":
            out["vision_embeds"] = (torch.randn(
                (batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                device=gen.device) * 0.02).to(getattr(torch, cfg.dtype))
        return out


def build_model(cfg_or_id) -> Model:
    if isinstance(cfg_or_id, str):
        from repro_torch.configs import get_config
        cfg_or_id = get_config(cfg_or_id)
    return Model(cfg_or_id)
