"""Attention: GQA with RoPE / qk-norm / QKV-bias / sliding window /
prefix-LM, the chunked softmax for long sequences, and KV-cache decode.

Plain PyTorch with the reference's ``repro/models/attention.py`` math:
scores in the activation dtype widened to f32, masked with ``NEG_INF =
-1e30``, exponentiated against the running row max, the probabilities
cast back for the value product, normalised in f32. The full-sequence
path loops over query chunks with the KV range statically truncated
(triangular skipping; the sliding window's ``k_lo``) and keeps a running
(max, sum, acc) over KV blocks inside each chunk. A sequence that fits
one chunk and one block runs the single-block softmax with no rescale.
Each query chunk is rematerialised in the backward (``layers.remat``),
always, as the reference checkpoints its ``attend``: only the chunk's q,
k and v stay alive for the backward, not its f32 scores and
probabilities. No ``scaled_dot_product_attention``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.layers import apply_rope, dense_init, remat, rms_norm
from repro_torch.sharding.rules import (fit_heads, grad_as_forward, on_local_cache,
                                        on_local_heads)

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
    # on a mesh whose head axis does not divide the heads, the projection's
    # columns are gathered before the split into heads (rules.fit_heads)
    q = fit_heads(q, h).reshape(B, -1, h, hd)
    k = fit_heads(k, kvh).reshape(B, -1, kvh, hd)
    v = fit_heads(v, kvh).reshape(B, -1, kvh, hd)
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


def _softmax_blocks(q, k, v, qpos0: int, spec: AttnSpec,
                    kv_chunk: int) -> torch.Tensor:
    """Masked softmax attention of one query chunk over KV blocks.

    q: (B, KV, G, qc, D); k / v: (B, KV, 1, Sk, D). Returns (B, KV, G, qc,
    D) in q's dtype. The first block sets (max, sum, acc); each later one
    rescales them by ``exp(m_old - m_new)`` (the reference's scan body).
    """
    qc, D = q.shape[-2], q.shape[-1]
    Sk = k.shape[-2]
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qpos = qpos0 + torch.arange(qc, device=dev)
    m = l = acc = None
    for lo in range(0, Sk, kv_chunk):
        hi = min(lo + kv_chunk, Sk)
        kb, vb = (k, v) if hi - lo == Sk else (k[..., lo:hi, :], v[..., lo:hi, :])
        s = (q @ kb.transpose(-1, -2)).float() * scale
        s = torch.where(_block_mask(qpos, torch.arange(lo, hi, device=dev), spec),
                        s, NEG_INF)
        if m is None:
            m = torch.clamp(torch.amax(s, dim=-1), min=NEG_INF)
            p = torch.exp(s - m[..., None])
            l = torch.sum(p, dim=-1)
            acc = (p.to(q.dtype) @ vb).float()
            continue
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + (p.to(q.dtype) @ vb).float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _shift_spec(spec: AttnSpec, k_lo: int) -> AttnSpec:
    """The spec seen from a KV range that starts at ``k_lo``."""
    if k_lo == 0 or spec.prefix_len == 0:
        return spec
    return dataclasses.replace(spec, prefix_len=max(0, spec.prefix_len - k_lo))


def multi_head_attention(params: dict, x: torch.Tensor, spec: AttnSpec, *,
                         x_kv: Optional[torch.Tensor] = None,
                         positions: Optional[torch.Tensor] = None,
                         q_chunk: int = 1024, kv_chunk: int = 1024
                         ) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder / cross).
    x: (B, S, d). Query chunks of ``q_chunk`` attend KV blocks of
    ``kv_chunk``; a causal chunk skips the blocks past its diagonal."""
    B, Sq, _ = x.shape
    x_kv = x if x_kv is None else x_kv
    Sk = x_kv.shape[1]
    dev = x.device
    if positions is None:
        positions = torch.arange(Sq, device=dev)[None, :]
    kv_positions = torch.arange(Sk, device=dev)[None, :]
    q, k, v = _project_qkv(params, x, x_kv, spec, positions, kv_positions)
    KV, G, D = spec.num_kv_heads, spec.num_heads // spec.num_kv_heads, spec.head_dim
    # on a mesh whose head axis does not divide the KV heads, the q heads
    # are gathered before their split into KV groups (k / v were, above)
    q = fit_heads(q, KV, dim=2)
    q = q.reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)   # (B, KV, G, Sq, D)
    k = k.permute(0, 2, 1, 3)[:, :, None]                   # (B, KV, 1, Sk, D)
    v = v.permute(0, 2, 1, 3)[:, :, None]

    def core(q, k, v):
        if Sq <= q_chunk:
            return remat(_softmax_blocks, q, k, v, 0, spec, kv_chunk)
        outs = []
        for lo in range(0, Sq, q_chunk):  # static triangular KV truncation
            hi = min(lo + q_chunk, Sq)
            k_lo, k_hi = 0, Sk
            if spec.causal and spec.prefix_len == 0:
                k_hi = hi  # blocks past the diagonal are skipped
                if spec.sliding_window > 0:
                    k_lo = max(0, (lo - spec.sliding_window) // kv_chunk * kv_chunk)
            outs.append(remat(
                _softmax_blocks, q[..., lo:hi, :], k[..., k_lo:k_hi, :],
                v[..., k_lo:k_hi, :], lo - k_lo, _shift_spec(spec, k_lo),
                kv_chunk))
        return torch.cat(outs, dim=-2)

    # on DTensors (the GSPMD path) each rank attends its own rows and heads,
    # and each rank's local chunks are the ones rematerialised
    out = on_local_heads(core, q, k, v)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, spec.num_heads * D)
    return grad_as_forward(out) @ params["wo"]


def reference_attention(params: dict, x: torch.Tensor, spec: AttnSpec,
                        x_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """O(S^2) oracle used by tests: one score block, ``torch.softmax``."""
    B, Sq, _ = x.shape
    x_kv = x if x_kv is None else x_kv
    Sk = x_kv.shape[1]
    dev = x.device
    q, k, v = _project_qkv(params, x, x_kv, spec,
                           torch.arange(Sq, device=dev)[None, :],
                           torch.arange(Sk, device=dev)[None, :])
    KV, G, D = spec.num_kv_heads, spec.num_heads // spec.num_kv_heads, spec.head_dim
    q = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() / math.sqrt(D)
    mask = _block_mask(torch.arange(Sq, device=dev), torch.arange(Sk, device=dev), spec)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(x.dtype), v)
    return out.reshape(B, Sq, spec.num_heads * D) @ params["wo"]


# --------------------------------------------------------------------------
# KV-cache decode
# --------------------------------------------------------------------------

def init_kv_cache(batch: int, max_seq: int, spec: AttnSpec, dtype,
                  device) -> dict:
    """Sliding-window specs allocate only a window-sized rolling buffer."""
    size = min(max_seq, spec.sliding_window) if spec.sliding_window else max_seq
    shape = (batch, size, spec.num_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_attention(params: dict, x: torch.Tensor, cache: dict,
                     spec: AttnSpec) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d). Returns (out (B, 1, d), new cache).

    The new k / v are written into the cache's own storage (a donated
    buffer: the cache passed in is consumed) and the returned cache holds
    the same tensors, with ``index + 1`` a new tensor. Slot, mask and
    position stay on the device: no host sync. The scores and the value
    product read the (B, S, KV, D) cache in place, one strided KV head
    at a time. On a mesh each rank writes and reads its own shard of the
    cache (``sharding.rules.on_local_cache``): its batch rows and KV
    heads, or its slots of a sequence-sharded cache.
    """
    B = x.shape[0]
    idx = cache["index"]
    q, k_new, v_new = _project_qkv(params, x, x, spec, idx[None, None],
                                   idx[None, None])
    core = lambda *a, **kw: _decode_core(*a, spec=spec, **kw)
    out = on_local_cache(core, q, k_new, v_new, cache["k"], cache["v"], idx)
    out = out.reshape(B, 1, spec.num_heads * spec.head_dim) @ params["wo"]
    return out, {"k": cache["k"], "v": cache["v"], "index": idx + 1}


def _decode_core(q, k_new, v_new, k_cache, v_cache, idx, *, spec: AttnSpec,
                 lo: int = 0, size: int | None = None, seq_max=None,
                 seq_sum=None) -> torch.Tensor:
    """The cache write and the attention of one token over (B, S, KV, D)
    caches that hold slots ``lo : lo + S`` of ``size``; ``seq_max`` /
    ``seq_sum`` reduce over the ranks that hold the other slots (none in
    one process). Returns (B, KV, G, D)."""
    B = q.shape[0]
    seq_max = seq_max or (lambda t: t)
    seq_sum = seq_sum or (lambda t: t)
    S = k_cache.shape[1]
    size = S if size is None else size
    slot = idx % size if spec.sliding_window > 0 else torch.clamp(idx, max=size - 1)
    if lo == 0 and S == size:
        at = slot.long().reshape(1)
        k_cache.index_copy_(1, at, k_new)
        v_cache.index_copy_(1, at, v_new)
    else:
        # only the rank whose slots hold ``slot`` writes its token there
        inside = (slot >= lo) & (slot < lo + S)
        at = torch.clamp(slot - lo, 0, S - 1).long().reshape(1)
        k_cache.index_copy_(1, at, torch.where(
            inside, k_new, k_cache.index_select(1, at)))
        v_cache.index_copy_(1, at, torch.where(
            inside, v_new, v_cache.index_select(1, at)))

    KV, D = k_cache.shape[2], spec.head_dim
    G = spec.num_heads // spec.num_kv_heads
    q = q.reshape(B, KV, G, D)
    s = torch.stack([q[:, h] @ k_cache[:, :, h].transpose(1, 2)
                     for h in range(KV)], dim=1)          # (B, KV, G, S)
    s = s.float() * (1.0 / math.sqrt(D))
    slots = lo + torch.arange(S, device=q.device)
    if spec.sliding_window > 0:
        # rolling buffer: a slot is valid if written within the last `size`
        # steps (including the token just inserted at `slot`)
        valid = (slot - slots) % size <= torch.clamp(idx, max=size - 1)
    else:
        valid = slots <= idx
    s = torch.where(valid, s, NEG_INF)
    e = torch.exp(s - seq_max(torch.amax(s, dim=-1, keepdim=True)))
    p = (e / seq_sum(torch.sum(e, dim=-1, keepdim=True))).to(q.dtype)
    return seq_sum(torch.stack([p[:, h] @ v_cache[:, :, h] for h in range(KV)],
                               dim=1))
