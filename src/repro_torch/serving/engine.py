"""Batched serving engine with a fixed-slot KV cache (continuous-batching
lite; reference: ``repro.serving.engine``): requests occupy slots; finished
slots are refilled from the queue each scheduling round. Each admitted
request is prefilled alone (batch 1) and each active slot decodes one token
per round, its next token the argmax of its logits. The reference's
``jax.jit`` of the decode step is a plain call here. Enc-dec requests are
refused at admission, as the reference refuses them (an engine request
carries no source frames).

The engine runs on the device of the model's weights. Each request records
on the host clock (``time.perf_counter``) when its first token was known
(the time to first token); reading a token back from the card waits for
it, so this is a time of finished device work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_s: Optional[float] = None   # perf_counter when token 1 was known


class ServingEngine:
    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 256, window: int = 0, eos_id: Optional[int] = None):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.window = window
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.device = params["embed"].device
        self._caches: Dict[int, object] = {}

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        while self.queue and len(self.active) < self.slots:
            req = self.queue.pop(0)
            slot = next(i for i in range(self.slots) if i not in self.active)
            cache = self.model.init_cache(1, self.max_len, window=self.window,
                                          device=self.device)
            batch = {"tokens": torch.as_tensor(req.prompt[None], dtype=torch.long,
                                               device=self.device)}
            if self.model.family == "encdec":
                raise NotImplementedError(
                    "enc-dec serving is not a slot-engine path: drive "
                    "api.Model directly (init_cache(B, max_len, src_len=...), "
                    "prefill(params, {'src_embeds', 'tgt_tokens'}, cache), "
                    "decode_step)")
            logits, cache = self.model.prefill(self.params, batch, cache,
                                               window=self.window)
            req.out_tokens.append(int(torch.argmax(logits[0])))
            req.first_token_s = time.perf_counter()
            self._caches[slot] = cache
            self.active[slot] = req

    def step(self):
        """One scheduling round: admit, then one decode step per active slot."""
        self._admit()
        finished = []
        for slot, req in list(self.active.items()):
            tok = torch.tensor([req.out_tokens[-1]], device=self.device)
            logits, cache = self.model.decode_step(self.params, self._caches[slot],
                                                   tok, window=self.window)
            nxt = int(torch.argmax(logits[0]))
            req.out_tokens.append(nxt)
            self._caches[slot] = cache
            if len(req.out_tokens) >= req.max_new_tokens or \
               (self.eos_id is not None and nxt == self.eos_id):
                req.done = True
                finished.append(req)
                del self.active[slot]
                del self._caches[slot]
        return finished

    def run_to_completion(self, max_rounds: int = 1000) -> List[Request]:
        done: List[Request] = []
        rounds = 0
        while (self.queue or self.active) and rounds < max_rounds:
            done.extend(self.step())
            rounds += 1
        return done
