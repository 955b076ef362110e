"""Block composition: pre-norm dense transformer blocks, the layer stack
and its one-token decode.

The layer params stay stacked — every leaf has a leading ``(L, …)`` dim —
so the param tree, and with it the FlatBuffer layout, is the reference's
(``repro/models/transformer.py``); so is the decode cache's (``k`` / ``v``
of (L, B, S, KV, D), ``index`` of (L,) int32). A Python loop over ``L``
replaces ``lax.scan``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    AttnSpec,
    decode_attention,
    init_attention,
    init_kv_cache,
    multi_head_attention,
)
from repro_torch.models.layers import ffn, init_ffn, rms_norm
from repro_torch.tree import tree_map


def attn_spec(cfg: ModelConfig, *, causal: bool = True,
              prefix_len: int = 0) -> AttnSpec:
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm,
        qkv_bias=cfg.qkv_bias,
        sliding_window=cfg.sliding_window if causal else 0,
        use_rope=cfg.use_rope,
        rope_theta=cfg.rope_theta,
        causal=causal,
        prefix_len=prefix_len,
    )


def init_block(gen, cfg: ModelConfig, dtype, device, layers: int = 1) -> dict:
    """Params of ``layers`` stacked dense blocks (leading dim ``layers``)."""
    zeros = lambda: torch.zeros((layers, cfg.d_model), dtype=dtype, device=device)
    return {
        "attn_norm": zeros(),
        "attn": init_attention(gen, cfg.d_model, attn_spec(cfg), dtype, device,
                               layers),
        "ffn_norm": zeros(),
        "mlp": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device, layers),
    }


def apply_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                prefix_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    spec = attn_spec(cfg, prefix_len=prefix_len)
    h = rms_norm(x, params["attn_norm"], cfg.norm_eps)
    x = x + multi_head_attention(params["attn"], h, spec)
    h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn(params["mlp"], h), aux


def decode_block(params: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    h = rms_norm(x, params["attn_norm"], cfg.norm_eps)
    a, cache = decode_attention(params["attn"], h, cache, attn_spec(cfg))
    x = x + a
    h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
    return x + ffn(params["mlp"], h), cache


def init_stack(gen, cfg: ModelConfig, dtype, device) -> dict:
    return init_block(gen, cfg, dtype, device, layers=cfg.num_layers)


def apply_stack(stacked: dict, x: torch.Tensor, cfg: ModelConfig, *,
                prefix_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked layers in order; the stack's own leading dim (all
    ``cfg.num_layers``, or one stage's slice of them) sets the depth."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(stacked["attn_norm"].shape[0]):
        layer = tree_map(lambda a: a[i], stacked)
        x, a = apply_block(layer, x, cfg, prefix_len=prefix_len)
        aux = aux + a
    return x, aux


def decode_stack(stacked: dict, x: torch.Tensor, caches: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One token through every layer; each layer's k / v are written in
    place into its slice of the stacked cache."""
    index = []
    for i in range(stacked["attn_norm"].shape[0]):
        layer = tree_map(lambda a: a[i], stacked)
        x, c = decode_block(layer, x, tree_map(lambda a: a[i], caches), cfg)
        index.append(c["index"])
    return x, {"k": caches["k"], "v": caches["v"], "index": torch.stack(index)}


def init_stack_cache(batch: int, max_seq: int, cfg: ModelConfig, dtype,
                     device) -> dict:
    one = init_kv_cache(batch, max_seq, attn_spec(cfg), dtype, "meta")
    return {name: torch.zeros((cfg.num_layers,) + tuple(a.shape), dtype=a.dtype,
                              device=device)
            for name, a in one.items()}
