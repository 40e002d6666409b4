"""Batched serving engine: continuous-batching-lite over fixed decode slots.

The port of the reference's LM engine.  The engine owns a fixed batch of
decode slots.  Requests are admitted into free slots by prefilling their
prompt one token at a time through the decode step; every engine tick
runs one decode step for all slots; finished sequences free their slot.
Greedy or temperature sampling.

Two behaviours of the reference are reproduced as they are, for parity:

* admission runs the decode step for *all* slots at ``idx = pos[slot]``
  of the slot being admitted, so each prompt token also writes the other
  live slots' K/V at that index, from their ``last_tok``;
* a tick uses one shared ``idx = pos.max()`` for every slot: its rotary
  position and its cache slot.

Each step runs on the engine's device under ``torch.inference_mode`` and
writes the engine's own cache in place.  The host keeps the positions and
the last tokens (numpy); a step copies its tokens in and, where the host
needs the next token, reads it back.  Sampling at ``temperature > 0``
draws from the engine's own seeded ``torch.Generator`` on its device, so
it is deterministic per seed but not the reference's ``jax.random`` bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.nn import decode as decode_mod
from repro_torch.nn.transformer import LM, ArchConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S0] token ids
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: LM, *, slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0, seed: int = 0,
                 device=None):
        dev, here = common.device(device), params.embed.device
        if here.type != dev.type or dev.index not in (None, here.index):
            raise ValueError(f"parameters on {here}, engine on {dev}")
        self.device = here
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = decode_mod.init_cache(cfg, slots, max_len, self.device)
        self.pos = np.zeros(slots, np.int32)        # next write index
        self.live: list[Request | None] = [None] * slots
        self.last_tok = np.zeros(slots, np.int32)
        #: decode steps run: one per admitted prompt token and one per tick
        self.steps = 0

    def _step(self, tokens: np.ndarray, idx: int) -> torch.Tensor:
        """One decode step for every slot; returns logits [slots, V]."""
        with torch.inference_mode():
            toks = torch.from_numpy(tokens.reshape(-1, 1)).to(self.device)
            logits, self.cache = decode_mod.decode_step(
                self.params, self.cfg, self.cache, {"tokens": toks}, idx)
        self.steps += 1
        return logits

    # -- admission ---------------------------------------------------------

    def try_admit(self, req: Request) -> bool:
        try:
            slot = self.live.index(None)
        except ValueError:
            return False
        # prefill the prompt token-by-token through the decode path, for
        # every slot at this slot's position (the reference's behaviour)
        logits = None
        for tok in req.prompt:
            tokens = self.last_tok.copy()
            tokens[slot] = int(tok)
            logits = self._step(tokens, int(self.pos[slot]))
            self.pos[slot] += 1
        self.live[slot] = req
        if logits is not None:
            self.last_tok[slot] = int(torch.argmax(logits[slot]))
            req.out.append(int(self.last_tok[slot]))
        # empty prompt: nothing to prefill, so there is no prompt-conditioned
        # logit yet — the first token comes from the next tick (the slot
        # decodes from its current last_tok, 0 at engine start = BOS-like)
        return True

    # -- one decode tick for the whole batch --------------------------------

    def tick(self):
        if all(r is None for r in self.live):
            return
        idx = int(self.pos.max())                    # slots share the tick idx
        logits = self._step(self.last_tok, idx)
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.to(torch.int32).cpu().numpy()
        for s, req in enumerate(self.live):
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            self.last_tok[s] = nxt[s]
            self.pos[s] += 1
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.done = True
                self.live[s] = None          # free the slot

    def run(self, requests: list[Request], max_ticks: int = 1000):
        """Drive to completion; returns the finished requests."""
        pending = list(requests)
        for _ in range(max_ticks):
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            if not pending and all(r is None for r in self.live):
                break
            self.tick()
        return [r for r in requests if r.done]
