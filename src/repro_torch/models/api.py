"""Uniform model API of the port's language models (reference:
``repro.models.api``).

``build_model(cfg)`` returns a :class:`Model` exposing:
  init(gen) -> params
  loss(params, batch) -> scalar            (training objective)
  forward_logits(params, batch) -> logits
  init_cache(batch, max_len, window=0, src_len=0, device=None) -> decode cache
  prefill(params, batch, cache, window=0) -> (last_logits, cache)
  decode_step(params, cache, token, window=0) -> (logits, cache)
  make_batch(gen, batch, seq) -> concrete batch  (smoke tests)

batch dict keys by family:
  dense/moe : tokens, labels
  vlm       : + vision_embeds [B, n_vision_tokens, D]  (stub ViT frontend)
  encdec    : src_embeds [B,Ss,D] (stub audio frontend), tgt_tokens, labels
  ssm/hybrid: tokens, labels

The port runs every family of the reference: ``dense``, ``moe`` and
``vlm`` (``lm``), ``hybrid`` (Hymba), ``ssm`` (xLSTM) and ``encdec``.
``init_cache`` takes the device its cache lives on (an xLSTM's cache is its
list of recurrent states; an enc-dec cache holds ``src_len`` memory rows,
``max_len`` when 0); weights and batches are made on their generator's
device. A VLM's windowed cache pins its vision tokens before the ring
(``lm._pinned``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hymba, lm, xlstm


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.family = cfg.family

    def _module(self):
        return {"ssm": xlstm, "hybrid": hymba, "encdec": encdec}.get(self.family, lm)

    # -- params ---------------------------------------------------------
    def init(self, gen: torch.Generator):
        return self._module().init_params(gen, self.cfg)

    # -- training -------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]):
        return self._module().loss_fn(params, self.cfg, batch)

    def forward_logits(self, params, batch):
        cfg = self.cfg
        if self.family == "ssm":
            return xlstm.forward(params, cfg, batch["tokens"])[0]
        if self.family == "hybrid":
            return hymba.forward(params, cfg, batch["tokens"])[0]
        if self.family == "encdec":
            memory = encdec.encode(params, cfg, batch["src_embeds"])
            return encdec.decode_forward(params, cfg, batch["tgt_tokens"], memory)[0]
        return lm.forward(params, cfg, batch["tokens"],
                          vision_embeds=batch.get("vision_embeds"))[0]

    # -- serving --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, window: int = 0,
                   src_len: int = 0, device=None):
        cfg = self.cfg
        if self.family == "ssm":
            return xlstm.init_state(cfg, batch, device)
        if self.family == "hybrid":
            return hymba.init_cache(cfg, batch, max_len, window=window,
                                    device=device)
        if self.family == "encdec":
            return encdec.init_cache(cfg, batch, max_len, src_len or max_len,
                                     window=window, device=device)
        return lm.init_cache(cfg, batch, max_len, window=window, device=device)

    def prefill(self, params, batch, cache, *, window: int = 0):
        cfg = self.cfg
        if self.family == "ssm":
            return xlstm.prefill(params, cfg, batch["tokens"], cache)
        if self.family == "hybrid":
            return hymba.prefill(params, cfg, batch["tokens"], cache,
                                 window=window)
        if self.family == "encdec":
            return encdec.prefill(params, cfg, batch["src_embeds"],
                                  batch["tgt_tokens"], cache, window=window)
        # a VLM's vision embeddings are consumed here; the cache covers them
        return lm.prefill(params, cfg, batch["tokens"], cache,
                          vision_embeds=batch["vision_embeds"]
                          if self.family == "vlm" else None,
                          window=window)

    def decode_step(self, params, cache, token, *, window: int = 0):
        cfg = self.cfg
        if self.family == "ssm":
            return xlstm.decode_step(params, cfg, cache, token)
        if self.family == "hybrid":
            return hymba.decode_step(params, cfg, cache, token, window=window)
        if self.family == "encdec":
            return encdec.decode_step(params, cfg, cache, token, window=window)
        return lm.decode_step(params, cfg, cache, token, window=window)

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
        if self.family == "encdec":
            st = encdec.tgt_len_for(seq)
            out = {"src_embeds": (torch.randn(
                       (batch, seq, cfg.d_model), generator=gen,
                       device=gen.device) * 0.02).to(getattr(torch, cfg.dtype)),
                   "tgt_tokens": tokens[:, :st], "labels": tokens[:, :st]}
        return out


def build_model(cfg_or_id) -> Model:
    if isinstance(cfg_or_id, str):
        from repro_torch.configs import get_config
        cfg_or_id = get_config(cfg_or_id)
    return Model(cfg_or_id)
