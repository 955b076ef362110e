"""Block composition: pre-norm transformer blocks (dense FFN, GeGLU for the
VLM, or MoE), the layer stack and its one-token decode, the
encoder-decoder layers (whisper: LayerNorm, self- and cross-attention, a
plain GELU MLP), and the zamba2-style hybrid backbone (Mamba2 layers + one
shared attention block with per-invocation LoRA adapters).

The layer params stay stacked — every leaf has a leading ``(L, …)`` dim —
so the param tree, and with it the FlatBuffer layout, is the reference's
(``repro/models/transformer.py``); so are the decode caches' (``k`` / ``v``
of (L, B, S, KV, D), ``index`` of (L,) int32; the hybrid's ``{"mamba":
{"conv", "h"}, "attn": {...}}``, its attention caches stacked over the
shared block's invocations). A Python loop over ``L`` replaces
``lax.scan``; decode writes every cache in place. With ``cfg.remat`` each
layer body of the training stacks is rematerialised (``layers.remat``)
where the reference wraps its scan body in ``jax.checkpoint``: the
decoder, Mamba2, encoder and decoder layers — not the hybrid's shared
block.
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
from repro_torch.models import ssm
from repro_torch.models.layers import (dense_init, ffn, gelu_ffn, init_ffn, init_mlp,
                                      layer_norm, mlp_ffn, remat, rms_norm)
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.sharding.rules import maybe_seq_shard, shard_batch_dim, unshard_dim
from repro_torch.tree import tree_map


def attn_spec(cfg: ModelConfig, *, causal: bool = True, prefix_len: int = 0,
              cross: bool = False) -> AttnSpec:
    """The config's attention; ``cross`` (the decoder's attention over the
    encoder output) has no qk-norm, no RoPE, no mask and no window."""
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm and not cross,
        qkv_bias=cfg.qkv_bias,
        sliding_window=cfg.sliding_window if causal and not cross else 0,
        use_rope=cfg.use_rope and not cross,
        rope_theta=cfg.rope_theta,
        causal=causal and not cross,
        prefix_len=prefix_len,
    )


def _dense_ffn(cfg: ModelConfig):
    """The dense block's FFN: GeGLU for the VLM (gemma), else SwiGLU."""
    return gelu_ffn if cfg.arch_type == "vlm" else ffn


def init_block(gen, cfg: ModelConfig, dtype, device, layers: int = 1) -> dict:
    """Params of ``layers`` stacked blocks (leading dim ``layers``)."""
    zeros = lambda: torch.zeros((layers, cfg.d_model), dtype=dtype, device=device)
    p = {
        "attn_norm": zeros(),
        "attn": init_attention(gen, cfg.d_model, attn_spec(cfg), dtype, device,
                               layers),
        "ffn_norm": zeros(),
    }
    if cfg.arch_type == "moe":
        p["moe"] = init_moe(gen, cfg.d_model, cfg.num_experts,
                            cfg.num_shared_experts, cfg.moe_d_ff, dtype, device,
                            layers)
    else:
        p["mlp"] = init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device, layers)
    return p


def _moe(params: dict, h: torch.Tensor, cfg: ModelConfig,
         capacity=None) -> tuple[torch.Tensor, torch.Tensor]:
    return moe_block(params["moe"], h, num_experts=cfg.num_experts,
                     top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                     aux_weight=cfg.router_aux_weight,
                     deterministic_capacity=capacity)


def apply_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                prefix_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    spec = attn_spec(cfg, prefix_len=prefix_len)
    # a residual stream sequence-sharded between blocks (maybe_seq_shard)
    # is gathered as the block starts: CUDA's matmul flattens (B, S), which
    # DTensor cannot do with both dims sharded, in the forward or in the
    # backward of a residual add
    x = unshard_dim(x, -2)
    h = rms_norm(x, params["attn_norm"], cfg.norm_eps)
    # the residual laid out as the batch after each add (on a mesh): left
    # partial over the head axes, it reaches the next products in layouts
    # whose sharding DTensor plans for minutes on a 3-axis mesh
    x = shard_batch_dim(x + multi_head_attention(params["attn"], h, spec))
    h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        y, aux = _moe(params, h, cfg)
    else:
        y = _dense_ffn(cfg)(params["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard_batch_dim(x + y), aux


def decode_block(params: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    h = rms_norm(x, params["attn_norm"], cfg.norm_eps)
    a, cache = decode_attention(params["attn"], h, cache, attn_spec(cfg))
    x = shard_batch_dim(x + a)
    h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        # decode never drops: every row's K entries fit this capacity
        E, K = cfg.num_experts, cfg.top_k
        y, _ = _moe(params, h, cfg, max(K, (x.shape[0] * K + E - 1) // E + 1))
    else:
        y = _dense_ffn(cfg)(params["mlp"], h)
    return shard_batch_dim(x + y), cache


def init_stack(gen, cfg: ModelConfig, dtype, device) -> dict:
    return init_block(gen, cfg, dtype, device, layers=cfg.num_layers)


def apply_stack(stacked: dict, x: torch.Tensor, cfg: ModelConfig, *,
                prefix_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked layers in order; the stack's own leading dim (all
    ``cfg.num_layers``, or one stage's slice of them) sets the depth."""

    def body(x, layer):
        x = maybe_seq_shard(x, cfg.seq_shard_activations)
        return apply_block(layer, x, cfg, prefix_len=prefix_len)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(stacked["attn_norm"].shape[0]):
        x, a = remat(body, x, tree_map(lambda a: a[i], stacked),
                     enabled=cfg.remat)
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


# --------------------------------------------------------------------------
# Encoder-decoder (whisper): encoder self-attn + decoder self/cross-attn
# --------------------------------------------------------------------------

def _norm_pair(cfg: ModelConfig, dtype, device, layers: int, name: str) -> dict:
    """A LayerNorm's stacked scale (ones) and bias (zeros)."""
    shape = (layers, cfg.d_model)
    return {name: torch.ones(shape, dtype=dtype, device=device),
            f"{name}_b": torch.zeros(shape, dtype=dtype, device=device)}


def init_enc_layer(gen, cfg: ModelConfig, dtype, device, layers: int = 1) -> dict:
    return {
        **_norm_pair(cfg, dtype, device, layers, "attn_norm"),
        "attn": init_attention(gen, cfg.d_model, attn_spec(cfg, causal=False),
                               dtype, device, layers),
        **_norm_pair(cfg, dtype, device, layers, "ffn_norm"),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, layers),
    }


def apply_enc_layer(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = layer_norm(x, p["attn_norm"], p["attn_norm_b"])
    x = shard_batch_dim(x + multi_head_attention(p["attn"], h,
                                                 attn_spec(cfg, causal=False)))
    h = layer_norm(x, p["ffn_norm"], p["ffn_norm_b"])
    return shard_batch_dim(x + mlp_ffn(p["mlp"], h))


def init_dec_layer(gen, cfg: ModelConfig, dtype, device, layers: int = 1) -> dict:
    d = cfg.d_model
    return {
        **_norm_pair(cfg, dtype, device, layers, "attn_norm"),
        "attn": init_attention(gen, d, attn_spec(cfg), dtype, device, layers),
        **_norm_pair(cfg, dtype, device, layers, "cross_norm"),
        "cross": init_attention(gen, d, attn_spec(cfg, cross=True), dtype, device,
                                layers),
        **_norm_pair(cfg, dtype, device, layers, "ffn_norm"),
        "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device, layers),
    }


def _cross_and_mlp(p: dict, x: torch.Tensor, enc: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    h = layer_norm(x, p["cross_norm"], p["cross_norm_b"])
    x = shard_batch_dim(x + multi_head_attention(p["cross"], h, attn_spec(cfg, cross=True),
                                                 x_kv=enc))
    h = layer_norm(x, p["ffn_norm"], p["ffn_norm_b"])
    return shard_batch_dim(x + mlp_ffn(p["mlp"], h))


def apply_dec_layer(p: dict, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    h = layer_norm(x, p["attn_norm"], p["attn_norm_b"])
    x = shard_batch_dim(x + multi_head_attention(p["attn"], h, attn_spec(cfg)))
    return _cross_and_mlp(p, x, enc, cfg)


def decode_dec_layer(p: dict, x: torch.Tensor, enc: torch.Tensor, cache: dict,
                     cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One token: self-attention over the KV cache (written in place), then
    cross-attention recomputing K / V over the whole encoder output, as
    the reference does."""
    h = layer_norm(x, p["attn_norm"], p["attn_norm_b"])
    a, cache = decode_attention(p["attn"], h, cache, attn_spec(cfg))
    return _cross_and_mlp(p, shard_batch_dim(x + a), enc, cfg), cache


def apply_enc_stack(stacked: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    for i in range(stacked["attn_norm"].shape[0]):
        x = remat(apply_enc_layer, tree_map(lambda a: a[i], stacked), x, cfg,
                  enabled=cfg.remat)
    return x


def apply_dec_stack(stacked: dict, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    for i in range(stacked["attn_norm"].shape[0]):
        x = remat(apply_dec_layer, tree_map(lambda a: a[i], stacked), x, enc,
                  cfg, enabled=cfg.remat)
    return x


def decode_dec_stack(stacked: dict, x: torch.Tensor, enc: torch.Tensor,
                     caches: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One token through every decoder layer; each layer's k / v written
    in place into its slice of the stacked cache."""
    index = []
    for i in range(stacked["attn_norm"].shape[0]):
        x, c = decode_dec_layer(tree_map(lambda a: a[i], stacked), x, enc,
                                tree_map(lambda a: a[i], caches), cfg)
        index.append(c["index"])
    return x, {"k": caches["k"], "v": caches["v"], "index": torch.stack(index)}


# --------------------------------------------------------------------------
# Hybrid (zamba2): Mamba2 backbone + ONE shared attention block, invoked
# every ``attn_period`` layers with a per-invocation LoRA delta on wq.
# --------------------------------------------------------------------------

def n_shared_invocations(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_period if cfg.attn_period else 0


def init_mamba_layer(gen, cfg: ModelConfig, dtype, device, layers: int) -> dict:
    return ssm.init_mamba(
        gen, cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
        state=cfg.ssm_state, conv_width=cfg.ssm_conv_width, dtype=dtype,
        device=device, layers=layers)


def init_mamba_stack(gen, cfg: ModelConfig, dtype, device) -> dict:
    """``cfg.num_layers`` stacked Mamba2 layers, each with its pre-norm."""
    return {"norm": torch.zeros((cfg.num_layers, cfg.d_model), dtype=dtype,
                                device=device),
            **init_mamba_layer(gen, cfg, dtype, device, cfg.num_layers)}


def init_hybrid(gen, cfg: ModelConfig, dtype, device) -> dict:
    """The Mamba2 stack, the one shared block (unstacked leaves) and the
    per-invocation LoRA pairs on wq (stacked over the invocations; the
    ``b`` half zero, so the delta starts at 0)."""
    mamba = init_mamba_stack(gen, cfg, dtype, device)
    one = lambda tree: tree_map(lambda a: a[0], tree)  # drop the layer dim
    d = cfg.d_model
    shared = {
        "attn_norm": torch.zeros((d,), dtype=dtype, device=device),
        "attn": one(init_attention(gen, d, attn_spec(cfg), dtype, device, 1)),
        "ffn_norm": torch.zeros((d,), dtype=dtype, device=device),
        "mlp": one(init_ffn(gen, d, cfg.d_ff, dtype, device, 1)),
    }
    n = max(n_shared_invocations(cfg), 1)
    r, h = cfg.shared_lora_rank, cfg.num_heads * cfg.resolved_head_dim
    lora = {"lora_a_q": dense_init(gen, d, (n, d, r), dtype, device),
            "lora_b_q": torch.zeros((n, r, h), dtype=dtype, device=device)}
    return {"mamba": mamba, "shared": shared, "lora": lora}


def _mamba_kw(cfg: ModelConfig) -> dict:
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                state=cfg.ssm_state)


def apply_mamba_stack(stacked: dict, x: torch.Tensor, cfg: ModelConfig,
                      lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """Layers ``lo:hi`` of a Mamba2 stack: x + mamba(rms_norm(x))."""

    def body(x, norm, lp):
        x = maybe_seq_shard(x, cfg.seq_shard_activations)
        y, _ = ssm.mamba_block(lp, rms_norm(x, norm, cfg.norm_eps),
                               chunk=cfg.ssm_chunk, **_mamba_kw(cfg))
        return x + y

    hi = stacked["norm"].shape[0] if hi is None else hi
    for i in range(lo, hi):
        lp = {k: v[i] for k, v in stacked.items() if k != "norm"}
        x = remat(body, x, stacked["norm"][i], lp, enabled=cfg.remat)
    return x


def decode_mamba_stack(stacked: dict, x: torch.Tensor, cache: dict,
                       cfg: ModelConfig, lo: int = 0,
                       hi: int | None = None) -> torch.Tensor:
    """One token through layers ``lo:hi``; each layer's ``h`` / ``conv``
    state is written in place into its slice of the stacked cache."""
    hi = stacked["norm"].shape[0] if hi is None else hi
    for i in range(lo, hi):
        lp = {k: v[i] for k, v in stacked.items() if k != "norm"}
        y, (h, conv) = ssm.mamba_decode(
            lp, rms_norm(x, stacked["norm"][i], cfg.norm_eps), cache["h"][i],
            cache["conv"][i], **_mamba_kw(cfg))
        cache["h"][i].copy_(h)
        cache["conv"][i].copy_(conv)
        x = x + y
    return x


def init_mamba_cache(batch: int, cfg: ModelConfig, dtype, device) -> dict:
    """``{"h": (L, B, H, P, N) f32, "conv": (L, B, K-1, C)}``, zeros."""
    h, conv = ssm.init_mamba_state(batch, cfg.d_model,
                                   conv_width=cfg.ssm_conv_width, dtype=dtype,
                                   device="meta", **_mamba_kw(cfg))
    L = cfg.num_layers
    return {"h": torch.zeros((L,) + tuple(h.shape), dtype=h.dtype, device=device),
            "conv": torch.zeros((L,) + tuple(conv.shape), dtype=conv.dtype,
                                device=device)}


def _lora_attn(shared: dict, lora_i: dict) -> dict:
    """The shared attention params with one invocation's q delta."""
    params = dict(shared["attn"])
    params["wq"] = params["wq"] + lora_i["lora_a_q"] @ lora_i["lora_b_q"]
    return params


def _shared_attn(shared: dict, lora_i: dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The shared block with ``lora_i``'s LoRA delta on the q projection."""
    h = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
    x = x + multi_head_attention(_lora_attn(shared, lora_i), h, attn_spec(cfg))
    h = rms_norm(x, shared["ffn_norm"], cfg.norm_eps)
    return x + ffn(shared["mlp"], h)


def apply_hybrid(params: dict, x: torch.Tensor,
                 cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Groups of ``attn_period`` mamba layers, each followed by the shared
    block; the layers past the last whole group trail."""
    period = cfg.attn_period or cfg.num_layers
    done = 0
    for i in range(n_shared_invocations(cfg)):
        x = apply_mamba_stack(params["mamba"], x, cfg, done, done + period)
        x = _shared_attn(params["shared"],
                         tree_map(lambda a: a[i], params["lora"]), x, cfg)
        done += period
    if done < cfg.num_layers:
        x = apply_mamba_stack(params["mamba"], x, cfg, done)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_hybrid_cache(batch: int, max_seq: int, cfg: ModelConfig, dtype,
                      device) -> dict:
    one = init_kv_cache(batch, max_seq, attn_spec(cfg), dtype, "meta")
    n = max(n_shared_invocations(cfg), 1)
    attn = {name: torch.zeros((n,) + tuple(a.shape), dtype=a.dtype, device=device)
            for name, a in one.items()}
    return {"mamba": init_mamba_cache(batch, cfg, dtype, device), "attn": attn}


def decode_hybrid(params: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One token; the mamba states and each invocation's k / v are written
    in place, ``index`` advances as a new (n_inv,) tensor."""
    period = cfg.attn_period or cfg.num_layers
    shared, attn = params["shared"], cache["attn"]
    spec = attn_spec(cfg)
    done, index = 0, []
    for i in range(n_shared_invocations(cfg)):
        x = decode_mamba_stack(params["mamba"], x, cache["mamba"], cfg, done,
                               done + period)
        h = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
        lora_i = tree_map(lambda t: t[i], params["lora"])
        a, c = decode_attention(_lora_attn(shared, lora_i), h,
                                tree_map(lambda t: t[i], attn), spec)
        index.append(c["index"])
        x = x + a
        h = rms_norm(x, shared["ffn_norm"], cfg.norm_eps)
        x = x + ffn(shared["mlp"], h)
        done += period
    if done < cfg.num_layers:
        x = decode_mamba_stack(params["mamba"], x, cache["mamba"], cfg, done)
    new_attn = {"k": attn["k"], "v": attn["v"],
                "index": torch.stack(index) if index else attn["index"]}
    return x, {"mamba": cache["mamba"], "attn": new_attn}
