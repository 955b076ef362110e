"""Serving: the one-token decode step and a small batched-request driver
(``repro/launch/serve.py``).

  srv = BatchedServer(model, params, batch=2, max_seq=96)   # on the card
  out = srv.generate(prompts, steps=12)                     # (B, steps) int32

``device="cpu"`` runs on the CPU; a CUDA request with no card raises.
The cache is updated in place (``Model.serve_step``), so one step moves
the weights and the cache once and copies neither.

``cache_specs`` / ``token_specs`` are the reference's sharding specs for
the decode state and the tokens (``sharding.P``). With a ``mesh`` (a
``launch.mesh.Mesh``, one process a device) ``make_serve_step`` and
``make_prefill_step`` run on DTensors laid out by them and by
``param_specs`` / ``batch_pspec``: the port's form of the reference's
``jax.jit(..., in_shardings=...)`` of the serve step and of
``model.forward`` (``repro/launch/dryrun.py``). In a rank::

  step = make_serve_step(model, mesh)                     # this rank's card
  params = distribute(params, param_specs(params, mesh), mesh)   # once
  logits, cache = step(params, cache, tokens)             # every rank
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch.train import _mesh_device, _relayout, resolve_device
from repro_torch.models.model import Model
from repro_torch.sharding.rules import P, _leaf_name, batch_pspec, distribute, param_specs
from repro_torch.tree import tree_flatten_with_path, tree_unflatten


def make_serve_step(model: Model, mesh=None, *, device="cuda") -> Callable:
    """``serve_step(params, cache, tokens) -> (logits, cache)``, one token
    for every batch row; the cache is consumed (updated in place).

    With a ``mesh``, every rank calls it: params, cache and tokens are laid
    out by ``param_specs``, ``cache_specs`` and ``token_specs`` (plain
    tensors holding the whole value on every rank are laid out at each
    call; DTensors so laid out are taken as they are), and the step runs
    on them under ``implicit_replication()`` and the mesh's
    ``dtensor_collectives()``, as the train step does. The cache comes
    back in its ``cache_specs`` layout (the reference's out_shardings),
    the (B, 1, V) logits whole on every rank."""
    device = _mesh_device(device, mesh)
    if mesh is None:
        def serve_step(params, cache, tokens):
            return model.serve_step(params, cache, tokens)

        return serve_step
    from torch.distributed.tensor.experimental import implicit_replication

    def mesh_serve_step(params, cache, tokens):
        with mesh.dtensor_collectives(), implicit_replication():
            params = distribute(params, param_specs(params, mesh), mesh)
            cache = distribute(cache, cache_specs(cache, mesh), mesh)
            tokens = distribute(tokens, token_specs(tuple(tokens.shape), mesh), mesh)
            logits, new_cache = model.serve_step(params, cache, tokens)
            new_cache = _relayout(new_cache, cache)
            return logits.full_tensor(), new_cache

    return mesh_serve_step


def make_prefill_step(model: Model, mesh=None, *, device="cuda") -> Callable:
    """``prefill(params, batch) -> logits``: ``model.forward`` with grad
    off. With a ``mesh``, on params laid out by ``param_specs`` and a
    batch by ``batch_pspec`` (each leaf's batch dim over the data axes),
    as the train step's forward; the logits come back as the forward
    leaves them (a DTensor, batch over the data axes)."""
    device = _mesh_device(device, mesh)

    @torch.no_grad()
    def prefill(params, batch):
        batch = {k: v.to(device) for k, v in batch.items()}
        if mesh is None:
            return model.forward(params, batch)
        from torch.distributed.tensor.experimental import implicit_replication

        with mesh.dtensor_collectives(), implicit_replication():
            params = distribute(params, param_specs(params, mesh), mesh)
            batch = distribute(batch, {k: batch_pspec(mesh, v.shape[0],
                                                  extra_dims=v.ndim - 1)
                                   for k, v in batch.items()}, mesh)
            return model.forward(params, batch)

    return prefill


def _shardable(dim: int, mesh, axis: str) -> bool:
    return axis in mesh.shape and dim % mesh.shape[axis] == 0


def cache_specs(cache, mesh):
    """Name/rank-based sharding of the decode state (works on ``meta``
    caches).

    Priority: batch dim -> 'data'; heads/feature dim -> 'model' (the first
    divisible candidate); everything else replicated. Covers KV caches
    (L, B, S, KV, D), SSM states (L, B, H, P, N), conv states (L, B, K, C)
    and whisper's encoder output (B, F, D). A GQA cache whose few KV heads
    the 'model' axis does not divide shards its sequence dim instead."""

    def leaf_spec(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        if name == "index" or len(shape) == 0:
            return P()
        if name in ("k", "v"):
            # (L, B, S, KV, D) or (B, S, KV, D)
            off = len(shape) - 4
            b, s, kv, _ = range(off, off + 4)
            if _shardable(shape[b], mesh, "data"):
                axes[b] = "data"
            if _shardable(shape[kv], mesh, "model"):
                axes[kv] = "model"
            elif _shardable(shape[s], mesh, "model"):
                axes[s] = "model"
        elif name == "h":
            # (L, B, H, P, N) ssm state
            off = len(shape) - 4
            b, hh, pp, nn = range(off, off + 4)
            if _shardable(shape[b], mesh, "data"):
                axes[b] = "data"
            for cand in (hh, pp, nn):
                if _shardable(shape[cand], mesh, "model"):
                    axes[cand] = "model"
                    break
        elif name == "conv":
            # (L, B, K-1, C)
            off = len(shape) - 3
            b, _, cc = range(off, off + 3)
            if _shardable(shape[b], mesh, "data"):
                axes[b] = "data"
            if _shardable(shape[cc], mesh, "model"):
                axes[cc] = "model"
        elif name == "enc":
            if _shardable(shape[0], mesh, "data"):
                axes[0] = "data"
            if _shardable(shape[-1], mesh, "model"):
                axes[-1] = "model"
        else:
            if len(shape) >= 2 and _shardable(shape[0], mesh, "data"):
                axes[0] = "data"
        while axes and axes[-1] is None:
            axes.pop()
        return P(*axes)

    pairs, treedef = tree_flatten_with_path(cache)
    return tree_unflatten(treedef, [leaf_spec(path, leaf) for path, leaf in pairs])


def token_specs(tokens_shape, mesh) -> P:
    if _shardable(tokens_shape[0], mesh, "data"):
        return P("data", None)
    return P(None, None)


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
        self._step = make_serve_step(model, device=self.device)

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
