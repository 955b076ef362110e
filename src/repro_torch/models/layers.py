"""Shared building blocks: init helpers, rematerialisation, RMSNorm,
LayerNorm, RoPE, the SwiGLU / GeGLU FFNs and whisper's plain GELU MLP.

Functions on plain tensors with the reference's layouts
(``repro/models/layers.py``). Weights are drawn from a ``torch.Generator``
and do not reproduce ``jax.random``'s numbers; tests carry the reference's
weights across with ``repro_torch.bridge`` instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(gen: torch.Generator | None, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    """N(0, 1/fan_in) weights. On the ``meta`` device (shape-only
    params, no generator) nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # in place: no second f32 copy of a large leaf before the cast
    return w.div_(max(fan_in, 1) ** 0.5).to(dtype)


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, its activations recomputed in the backward instead of
    saved (``jax.checkpoint``): only ``args`` stay alive for the backward.
    The autograd graph is the one ``fn`` builds, so every gradient term
    adds in the same order as without. Without grad mode nothing would be
    saved, and ``fn`` simply runs. No model op draws random numbers, so
    no RNG state is stashed."""
    if not enabled or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + scale)`` (zero-initialised scales) — not
    ``torch.nn.RMSNorm``, which scales by ``scale``."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs). x: (..., S, H, D);
    positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    angles = positions[..., :, None, None].float() * freqs      # (..., S, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_ffn(gen, d_model: int, d_ff: int, dtype, device,
             layers: int) -> dict:
    """SwiGLU weights for ``layers`` stacked blocks: (L, d, f) / (L, f, d)."""
    return {
        "w_gate": dense_init(gen, d_model, (layers, d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, d_model, (layers, d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, d_ff, (layers, d_ff, d_model), dtype, device),
    }


def ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def gelu_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """GeGLU variant (gemma / paligemma): the SwiGLU weights, GELU gate."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (_gelu(g) * u) @ params["w_down"]


def init_mlp(gen, d_model: int, d_ff: int, dtype, device, layers: int) -> dict:
    """2-layer MLP weights (whisper): up + down, no gate, stacked."""
    return {
        "w_up": dense_init(gen, d_model, (layers, d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, d_ff, (layers, d_ff, d_model), dtype, device),
    }


def mlp_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain 2-layer GELU MLP (whisper): w_up / w_down, no gate."""
    return _gelu(x @ params["w_up"]) @ params["w_down"]
