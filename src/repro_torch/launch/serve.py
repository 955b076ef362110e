"""Serving: the one-token decode step and a small batched-request driver
(``repro/launch/serve.py``).

  srv = BatchedServer(model, params, batch=2, max_seq=96)   # on the card
  out = srv.generate(prompts, steps=12)                     # (B, steps) int32

``device="cpu"`` runs on the CPU; a CUDA request with no card raises.
The cache is updated in place (``Model.serve_step``), so one step moves
the weights and the cache once and copies neither.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch.train import resolve_device
from repro_torch.models.model import Model


def make_serve_step(model: Model) -> Callable:
    def serve_step(params, cache, tokens):
        return model.serve_step(params, cache, tokens)

    return serve_step


class BatchedServer:
    """Greedy batched server: fixed batch slots, each slot an independent
    request, stepping one token for every slot per call."""

    def __init__(self, model: Model, params, *, batch: int, max_seq: int,
                 device="cuda"):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.cache = model.init_cache(batch, max_seq, self.device)
        self._step = make_serve_step(model)

    def prefill_tokens(self, prompts: torch.Tensor) -> torch.Tensor:
        """Teacher-forced prefill by stepping the prompt one token at a
        time through the same serve step; returns the last logits."""
        prompts = prompts.to(self.device)
        last = None
        for t in range(prompts.shape[1]):
            last, self.cache = self._step(self.params, self.cache,
                                          prompts[:, t:t + 1])
        return last

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, steps: int) -> torch.Tensor:
        """``steps`` greedy tokens per slot after the prompts, as a (B,
        steps) int32 tensor on the server's device. Ties go to the first
        index, as ``jnp.argmax``; nothing waits for the device inside."""
        logits = self.prefill_tokens(prompts)
        outs = []
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        for _ in range(steps):
            outs.append(tok)
            logits, self.cache = self._step(self.params, self.cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return torch.cat(outs, dim=1)
