"""Deterministic synthetic data pipelines (``repro/data/pipeline.py``).

Batches are reproducible from (seed, epoch, step, shard) alone. Token
batches follow a learnable synthetic language (a fixed random bigram
automaton), so losses descend; image batches are class-dependent Gaussian
prototypes plus noise. Sampling is numpy, bit-for-bit the reference's;
batches come back as torch tensors on the requested device (tokens and
labels int32, images f32 NHWC).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 1024
    seq_len: int = 128
    batch_size: int = 8          # per-worker batch (paper's scheduling unit)
    steps_per_epoch: int = 50
    num_shards: int = 1          # total workers
    shard: int = 0               # this worker's rank


def _bigram_table(seed: int, vocab: int) -> np.ndarray:
    """Row-stochastic transition logits of the synthetic language."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    table = rng.normal(size=(vocab, vocab)).astype(np.float32)
    hot = rng.integers(0, vocab, size=(vocab, 4))
    for i in range(vocab):
        table[i, hot[i]] += 4.0
    return table


def _softmax_rows(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


class TokenPipeline:
    """Iterable of {"tokens", "labels"} batches; indexable by (epoch, step)."""

    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._probs = _softmax_rows(_bigram_table(cfg.seed, cfg.vocab_size))

    def batch_at(self, epoch: int, step: int) -> dict:
        cfg = self.cfg
        key = np.random.default_rng((cfg.seed, epoch, step, cfg.shard, 0xDA7A))
        B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = key.integers(0, V, size=B)
        for t in range(1, S + 1):  # vectorized ancestral sampling
            cum = np.cumsum(self._probs[toks[:, t - 1]], axis=1)
            u = key.random(B)[:, None]
            toks[:, t] = np.argmax(cum > u, axis=1)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]))}

    def epoch(self, epoch: int) -> Iterator[dict]:
        for step in range(self.cfg.steps_per_epoch):
            yield self.batch_at(epoch, step)

    def optimal_xent(self, n_mc: int = 4096) -> float:
        """Entropy rate of the automaton = the loss floor."""
        rng = np.random.default_rng(self.cfg.seed + 1)
        rows = rng.integers(0, self.cfg.vocab_size, size=n_mc)
        p = self._probs[rows]
        return float(-np.mean(np.sum(p * np.log(p + 1e-20), axis=1)))


class ImagePipeline:
    """Synthetic image classification: class-dependent Gaussian blobs +
    noise, ``{"images": (B, H, W, 3) f32, "labels": (B,) int32}``."""

    def __init__(self, cfg: DataConfig, image_size: int = 16,
                 num_classes: int = 10, noise: float = 1.5, device="cpu"):
        self.cfg = cfg
        self.image_size = image_size
        self.num_classes = num_classes
        self.noise = noise
        self.device = torch.device(device)
        rng = np.random.default_rng(cfg.seed ^ 0x1333)
        self._proto = rng.normal(
            size=(num_classes, image_size, image_size, 3)).astype(np.float32)

    def batch_at(self, epoch: int, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, epoch, step, cfg.shard, 0x13))
        B = cfg.batch_size
        labels = rng.integers(0, self.num_classes, size=B)
        noise = rng.normal(size=(B, self.image_size, self.image_size, 3))
        images = self._proto[labels] + self.noise * noise.astype(np.float32)
        return {"images": torch.from_numpy(images).to(self.device),
                "labels": torch.from_numpy(labels.astype(np.int32)).to(self.device)}

    def epoch(self, epoch: int) -> Iterator[dict]:
        for step in range(self.cfg.steps_per_epoch):
            yield self.batch_at(epoch, step)


def shard_config(cfg: DataConfig, num_shards: int, shard: int) -> DataConfig:
    return dataclasses.replace(cfg, num_shards=num_shards, shard=shard)
