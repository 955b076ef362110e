"""Attention: GQA with RoPE / qk-norm / QKV-bias / sliding window.

Plain PyTorch with an f32 masked softmax (``NEG_INF = -1e30``), the
reference's ``repro/models/attention.py`` math on one KV block: scores in
the activation dtype widened to f32, masked, exponentiated against the row
max, the probabilities cast back for the value product, normalised in
f32. No ``scaled_dot_product_attention``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


@dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0
    use_rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    prefix_len: int = 0  # prefix-LM: first N positions attend bidirectionally


def init_attention(gen, d_model: int, spec: AttnSpec, dtype, device,
                   layers: int) -> dict:
    """Attention weights for ``layers`` stacked blocks."""
    h, kvh, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    L = layers
    p = {
        "wq": dense_init(gen, d_model, (L, d_model, h * hd), dtype, device),
        "wk": dense_init(gen, d_model, (L, d_model, kvh * hd), dtype, device),
        "wv": dense_init(gen, d_model, (L, d_model, kvh * hd), dtype, device),
        "wo": dense_init(gen, h * hd, (L, h * hd, d_model), dtype, device),
    }
    zeros = lambda n: torch.zeros((L, n), dtype=dtype, device=device)
    if spec.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(h * hd), zeros(kvh * hd), zeros(kvh * hd)
    if spec.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    return p


def _project_qkv(params, x, x_kv, spec: AttnSpec, positions, kv_positions):
    B = x.shape[0]
    h, kvh, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = x @ params["wq"]
    k = x_kv @ params["wk"]
    v = x_kv @ params["wv"]
    if spec.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, -1, h, hd)
    k = k.reshape(B, -1, kvh, hd)
    v = v.reshape(B, -1, kvh, hd)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, kv_positions, spec.rope_theta)
    return q, k, v


def _block_mask(qpos: torch.Tensor, kpos: torch.Tensor,
                spec: AttnSpec) -> torch.Tensor:
    """(q, k) bool mask of allowed attention."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if spec.causal:
        causal = kpos[None, :] <= qpos[:, None]
        if spec.prefix_len > 0:
            causal = causal | (kpos[None, :] < spec.prefix_len)
        m = m & causal
    if spec.sliding_window > 0:
        m = m & (kpos[None, :] > qpos[:, None] - spec.sliding_window)
    return m


def multi_head_attention(params: dict, x: torch.Tensor, spec: AttnSpec, *,
                         x_kv: Optional[torch.Tensor] = None,
                         positions: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, d)."""
    B, Sq, _ = x.shape
    x_kv = x if x_kv is None else x_kv
    Sk = x_kv.shape[1]
    dev = x.device
    if positions is None:
        positions = torch.arange(Sq, device=dev)[None, :]
    kv_positions = torch.arange(Sk, device=dev)[None, :]
    q, k, v = _project_qkv(params, x, x_kv, spec, positions, kv_positions)
    KV, G, D = spec.num_kv_heads, spec.num_heads // spec.num_kv_heads, spec.head_dim
    q = q.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)   # (B, KV, G, Sq, D)
    k = k.permute(0, 2, 1, 3)[:, :, None]                   # (B, KV, 1, Sk, D)
    v = v.permute(0, 2, 1, 3)[:, :, None]
    s = (q @ k.transpose(-1, -2)).float() * (1.0 / math.sqrt(D))
    mask = _block_mask(torch.arange(Sq, device=dev),
                       torch.arange(Sk, device=dev), spec)
    s = torch.where(mask, s, NEG_INF)
    m = torch.clamp(torch.amax(s, dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = (p.to(q.dtype) @ v).float()
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, spec.num_heads * D)
    return out @ params["wo"]
