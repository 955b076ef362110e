"""Model API: ``build_model(cfg)`` returns a ``Model`` whose functions are

  init(device, seed=0)      -> params (nested dict, stacked layer leaves)
  loss_fn(params, batch)    -> (loss, metrics)
  forward(params, batch)    -> logits

Slice 1 ports the dense decoder family (``repro/models/model.py``
``_build_decoder``). ``init(device="meta")`` gives shape-only params, the
counterpart of ``jax.eval_shape(model.init, ...)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import apply_stack, init_stack

XENT_CHUNK = 512


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    forward: Callable


def _generator(device, seed: int) -> torch.Generator | None:
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _embed_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    if torch.device(device).type == "meta":
        emb = torch.empty((v, d), dtype=dtype, device=device)
    else:
        emb = torch.randn((v, d), generator=gen, dtype=torch.float32,
                          device=device).to(dtype) * 0.02
    p = {"embedding": emb,
         "final_norm": torch.zeros((d,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        if torch.device(device).type == "meta":
            p["lm_head"] = torch.empty((d, v), dtype=dtype, device=device)
        else:
            p["lm_head"] = (torch.randn((d, v), generator=gen,
                                        dtype=torch.float32, device=device)
                            * d ** -0.5).to(dtype)
    return p


def _logits(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].T
    else:
        logits = x @ p["lm_head"]
    pad = cfg.padded_vocab - cfg.vocab_size
    if pad:  # mask padded vocab ids
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    return logits


def _embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # F.embedding, not ``emb[tokens]``: on the CPU the indexing backward
    # accumulates repeated tokens with parallel atomic adds (run-to-run
    # different sums); embedding's backward sums each row in token order
    return torch.nn.functional.embedding(tokens.long(), p["embedding"])


def _xent_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _xent_sum(logits, labels) / labels.numel()


def _sequence_xent(p: dict, h: torch.Tensor, labels: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Next-token xent from hidden states, in ``XENT_CHUNK``-long sequence
    chunks when the sequence is a multiple longer than one chunk."""
    B, S, _ = h.shape
    if S % XENT_CHUNK or S <= XENT_CHUNK:
        return _xent(_logits(p, h, cfg), labels)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, S, XENT_CHUNK):
        hc, lc = h[:, lo:lo + XENT_CHUNK], labels[:, lo:lo + XENT_CHUNK]
        total = total + _xent_sum(_logits(p, hc, cfg), lc)
    return total / (B * S)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"not yet ported: {cfg.arch_type} family")
    return _build_decoder(cfg, cfg.torch_dtype)


def _build_decoder(cfg: ModelConfig, dtype) -> Model:
    def init(device="cuda", seed: int = 0) -> dict:
        gen = _generator(device, seed)
        p = _embed_init(gen, cfg, dtype, device)
        p["layers"] = init_stack(gen, cfg, dtype, device)
        return p

    def backbone(p, x):
        x, aux = apply_stack(p["layers"], x, cfg)
        return rms_norm(x, p["final_norm"], cfg.norm_eps), aux

    def forward(p, batch):
        h, _ = backbone(p, _embed(p, batch["tokens"], cfg))
        return _logits(p, h, cfg)

    def loss_fn(p, batch):
        h, aux = backbone(p, _embed(p, batch["tokens"], cfg))
        xent = _sequence_xent(p, h, batch["labels"], cfg)
        return xent + aux, {"xent": xent, "aux": aux}

    return Model(cfg, init, loss_fn, forward)
