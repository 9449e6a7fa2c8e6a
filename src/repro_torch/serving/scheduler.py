"""Continuous-batching request scheduler for the serving path.

A fixed pool of B cache slots; requests join a FIFO queue, are admitted
into free slots (their prompt is prefilled, batch 1, and copied into that
slot of every cache tensor), and each engine step decodes one token for
every slot with one (B, 1) ``decode_step`` over the shared cache.  A
request that reaches EOS or its ``max_new`` tokens frees its slot at once
for the next queued request.  Each slot's position lives in the cache's
``pos`` vector, so ragged lengths need nothing else: attention masks derive
from it.  Idle slots decode too, on whatever their last token was; their
results are never read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models.cache import init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor        # (S,) token ids
    max_new: int
    eos_id: Optional[int] = None
    # filled during serving
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # a list here receives, row by row, the (vocab,) fp32 logits that each
    # emitted token was taken from (the prefill's, then each decode step's)
    logits: Optional[List[torch.Tensor]] = None


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    prefills: int = 0
    completed: int = 0
    decoded_tokens: int = 0


def _write_slot(batch, req, slot: int) -> None:
    """Copy a batch-1 cache (or entry) into slot ``slot`` of the batch
    cache, tensor by tensor, in place: batch is dim 0 of every tensor."""
    if isinstance(batch, torch.Tensor):
        batch[slot] = req[0]
    elif isinstance(batch, dict):
        for key in batch:
            _write_slot(batch[key], req[key], slot)
    else:                                   # lists and state tuples
        for b, r in zip(batch, req):
            _write_slot(b, r, slot)


class ContinuousBatchingEngine:
    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_len: int, cache_dtype=torch.bfloat16, device=None, *,
                 use_kernel: bool = True):
        """``device=None`` means ``cuda``.  ``cache_dtype`` defaults to
        ``prefill``'s, so that the engine's tokens equal the sequential
        ``generate``'s.  ``use_kernel=False`` runs the kernels' plain
        versions on any device."""
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.device = torch.device("cuda" if device is None else device)
        self._cache_dtype = cache_dtype
        self.use_kernel = use_kernel
        self.cache = init_cache(cfg, batch_slots, max_len, cache_dtype,
                                device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.next_tok = torch.zeros((batch_slots, 1), dtype=torch.long,
                                    device=self.device)
        self.queue: List[Request] = []
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.B):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.as_tensor(req.prompt, device=self.device)
            logits, req_cache = prefill(
                self.params, self.cfg, prompt[None].long(), self.max_len,
                cache_dtype=self._cache_dtype, use_kernel=self.use_kernel)
            self.stats.prefills += 1
            _write_slot(self.cache, req_cache, slot)
            if req.logits is not None:
                req.logits.append(logits[0, -1])
            self.next_tok[slot, 0] = logits[0, -1].argmax()
            self.slot_req[slot] = req

    # ------------------------------------------------------------------
    def step(self) -> Dict[int, int]:
        """One engine step; returns {rid: token} emitted this step."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return {}
        logits, self.cache = decode_step(self.params, self.cfg,
                                         self.next_tok, self.cache,
                                         use_kernel=self.use_kernel)
        self.stats.steps += 1
        emitted: Dict[int, int] = {}
        tokens = self.next_tok[:, 0].tolist()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = tokens[slot]
            req.output.append(tok)
            emitted[req.rid] = tok
            self.stats.decoded_tokens += 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.output) >= req.max_new:
                req.done = True
                self.slot_req[slot] = None
                self.stats.completed += 1
            elif req.logits is not None:
                req.logits.append(logits[slot, -1])
        self.next_tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        return emitted

    def run(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.stats
