"""Mamba2 / SSD (state-space duality) blocks (``repro/models/ssm.py``).
[arXiv:2405.21060]

Train / prefill uses the chunked SSD algorithm (quadratic inside chunks of
``ssm_chunk`` tokens, linear recurrence across chunk states, a Python loop
over chunks in f32 for ``lax.scan``); decode is the O(1)-per-token
recurrent update. ``ssd_recurrent_ref`` is the sequential oracle used by
tests. The reference's einsums are written as explicit products, so the
contraction order (and the memory of each intermediate) is fixed rather
than left to an einsum planner.

The casts mirror the reference's: the SSD runs in f32 and returns the
activation dtype, ``dt`` is ``softplus(dt.f32 + dt_bias)``, the skip term
``y + D·x`` and the causal conv (K shifted products summed in index
order, in the full pass and in decode alike) run in the activation dtype,
and the gated norm is ``rms_norm``'s ``(1 + scale)``.

On a DTensor mesh (the GSPMD path) the causal conv, the SSD scan and
their decode steps run on each rank's own batch rows and channels or
heads (``sharding.rules.on_local_shards``; Bm / Cm are shared by every
head), and the z | xBC | dt and x | B | C slices, which cross the 'model'
shards of ``in_proj``'s output and of the conv channels, read those
gathered over 'model'.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding.rules import grad_as_forward, on_local_shards, unshard_dim


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., Q, H) -> (..., H, Q, Q) lower-triangular pairwise sums
    S[i, j] = sum_{j < s <= i} dA[s]; -inf above the diagonal, masked
    BEFORE the caller's exp (exp then mask would give inf·0 = NaN in
    backward)."""
    q = dA.shape[-2]
    cs = torch.cumsum(dA, dim=-2).movedim(-1, -2)            # (..., H, Q)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, s, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P), dt (B, L, H) softplus'ed, A (H,) negative, Bm / Cm
    (B, L, N), h0 (B, H, P, N). Returns (y (B, L, H, P), h_final (B, H, P,
    N) f32)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    dA = dtc * A.to(f32)                                     # (b, c, q, h)
    dAcs = torch.cumsum(dA, dim=2)                           # inclusive

    # 1) diagonal (intra-chunk) blocks: (C·Bᵀ ∘ Ltri) · (x·dt)
    Ltri = torch.exp(_segsum(dA))                            # (b, c, h, q, s)
    xdt = xc * dtc[..., None]                                # (b, c, s, h, p)
    cb = Cc @ Bc.transpose(-1, -2)                           # (b, c, q, s)
    y_diag = ((cb[:, :, None] * Ltri) @ xdt.permute(0, 1, 3, 2, 4)
              ).permute(0, 1, 3, 2, 4)                       # (b, c, q, h, p)

    # 2) per-chunk output states
    decay = torch.exp(dAcs[:, :, -1:, :] - dAcs)             # (b, c, q, h)
    xw = xc * (decay * dtc)[..., None]                       # (b, c, s, h, p)
    states = xw.permute(0, 1, 3, 4, 2) @ Bc[:, :, None]      # (b, c, h, p, n)

    # 3) inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(dAcs[:, :, -1, :])               # (b, c, h)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b, c, h, p, n)

    # 4) state -> output contribution
    y_off = (prev_states @ Cc[:, :, None].transpose(-1, -2)  # (b, c, h, p, q)
             ).permute(0, 1, 4, 2, 3) * torch.exp(dAcs)[..., None]
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)[:, :L]
    return y.to(x.dtype), h


def ssd_recurrent_ref(x, dt, A, Bm, Cm, h0=None):
    """Sequential oracle: one recurrent step per token."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(L):
        dtt = dt[:, t]
        dec = torch.exp(dtt * A.to(f32))
        h = h * dec[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtt, x[:, t].to(f32), Bm[:, t].to(f32))
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """One token: x (B, H, P), dt (B, H), Bm / Cm (B, N), h (B, H, P, N)."""
    f32 = torch.float32
    dt = dt.to(f32)
    dec = torch.exp(dt * A.to(f32))
    h = h * dec[..., None, None] + (dt[..., None] * x.to(f32))[..., None] \
        * Bm.to(f32)[:, None, None, :]
    y = (h @ Cm.to(f32)[:, None, :, None])[..., 0]           # (b, h, p)
    return y.to(x.dtype), h


# --------------------------------------------------------------------------
# Full Mamba2 block (in_proj -> causal conv -> SSD -> gated norm -> out_proj)
# --------------------------------------------------------------------------

def mamba_dims(d_model: int, expand: int, head_dim: int, state: int):
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    conv_dim = d_inner + 2 * state
    return d_inner, nheads, conv_dim


def init_mamba(gen, d_model: int, *, expand: int, head_dim: int, state: int,
               conv_width: int, dtype, device, layers: int) -> dict:
    """Mamba2 weights for ``layers`` stacked blocks; A_log / D / dt_bias
    are f32."""
    d_inner, nheads, conv_dim = mamba_dims(d_model, expand, head_dim, state)
    L = layers
    proj_out = 2 * d_inner + 2 * state + nheads  # z, x, B, C, dt
    f32 = lambda fill: torch.full((L, nheads), fill, dtype=torch.float32,
                                  device=device)
    return {
        "in_proj": dense_init(gen, d_model, (L, d_model, proj_out), dtype, device),
        "conv_w": dense_init(gen, conv_width, (L, conv_width, conv_dim), dtype,
                             device),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "A_log": f32(0.0),
        "D": f32(1.0),
        "dt_bias": f32(0.0),
        "ssm_norm": torch.zeros((L, d_inner), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_inner, (L, d_inner, d_model), dtype, device),
    }


def _split_proj(proj, d_inner, state, nheads):
    # the slices cross the 'model' shards of the projection's columns: on
    # a mesh they are cut from its gather over 'model'
    proj = unshard_dim(proj, -1)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * state]
    dt = proj[..., 2 * d_inner + 2 * state:]
    return z, xbc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xbc: (B, L, C); depthwise causal conv of width K: the K shifted
    products summed in index order in the activation dtype."""
    K, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = pad[:, 0:L] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + L] * w[i]
    return F.silu(out + b)


def _conv_with_state(xbc, w, b, conv0=None):
    """The causal conv of ``xbc`` (after ``conv0``'s K-1 tokens, where
    given) and the last K-1 tokens of its input, the next conv state."""
    K = w.shape[0]
    if conv0 is not None:
        xbc_in = torch.cat([conv0, xbc], dim=1)
        return causal_conv(xbc_in, w, b)[:, conv0.shape[1]:], xbc_in[:, -(K - 1):]
    return causal_conv(xbc, w, b), F.pad(xbc, (0, 0, K - 1, 0))[:, -(K - 1):]


def _conv_step(conv_state, xbc, w, b):
    """One token's conv: the K products of the window summed in index
    order, as ``causal_conv``; -> (its output (B, 1, C), the window's last
    K-1 tokens)."""
    window = torch.cat([conv_state, xbc], dim=1)             # (B, K, conv)
    acc = window[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i] * w[i]
    return F.silu(acc + b)[:, None], window[:, 1:]


def mamba_block(params: dict, x: torch.Tensor, *, expand: int, head_dim: int,
                state: int, chunk: int, h0=None, conv0=None):
    """x: (B, L, d). Returns (out, (h_final, conv_state))."""
    B, L, d = x.shape
    d_inner, nheads, conv_dim = mamba_dims(d, expand, head_dim, state)
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj, d_inner, state, nheads)
    # each rank convolves its own batch rows and channels
    conv_out, conv_state = on_local_shards(
        _conv_with_state, (xbc, params["conv_w"], params["conv_b"], conv0),
        [(0, 2), (None, 1), (None, 0), (0, 2)], [(0, 2), (0, 2)])
    conv_out = unshard_dim(conv_out, -1)   # x | B | C cross the channel shards
    xs = conv_out[..., :d_inner].reshape(B, L, nheads, head_dim)
    Bm = conv_out[..., d_inner:d_inner + state]
    Cm = conv_out[..., d_inner + state:]
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    # each rank scans its own batch rows and heads
    y, h = on_local_shards(
        lambda x_, dt_, A_, B_, C_, h_: ssd_chunked(x_, dt_, A_, B_, C_, chunk, h0=h_),
        (xs, dt, A, Bm, Cm, h0),
        [(0, 2), (0, 2), (None, 0), (0, None), (0, None), (0, 1)], [(0, 2), (0, 1)])
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xs
    # where the head axis does not divide the heads, the gradient comes
    # back with its channels split inside a head: laid out as y first
    y = grad_as_forward(y.reshape(B, L, d_inner))
    y = rms_norm(y * F.silu(z), params["ssm_norm"])
    return y @ params["out_proj"], (h, conv_state)


def mamba_decode(params: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                 conv_state: torch.Tensor, *, expand: int, head_dim: int,
                 state: int):
    """x: (B, 1, d); ssm_state (B, H, P, N) f32; conv_state (B, K-1,
    conv_dim). Returns (out, (h, new_conv_state)), both states new
    tensors."""
    B, _, d = x.shape
    d_inner, nheads, conv_dim = mamba_dims(d, expand, head_dim, state)
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj, d_inner, state, nheads)
    conv_out, new_conv = on_local_shards(
        _conv_step, (conv_state, xbc, params["conv_w"], params["conv_b"]),
        [(0, 2), (0, 2), (None, 1), (None, 0)], [(0, 2), (0, 2)])
    conv_out = unshard_dim(conv_out, -1)
    xs = conv_out[..., :d_inner].reshape(B, nheads, head_dim)
    Bm = conv_out[:, 0, d_inner:d_inner + state]
    Cm = conv_out[:, 0, d_inner + state:]
    dt = _softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h = on_local_shards(
        ssd_decode_step, (ssm_state, xs, dt, A, Bm, Cm),
        [(0, 1), (0, 1), (0, 1), (None, 0), (0, None), (0, None)], [(0, 1), (0, 1)])
    y = y + params["D"].to(y.dtype)[None, :, None] * xs
    y = y.reshape(B, 1, d_inner)
    y = rms_norm(y * F.silu(z), params["ssm_norm"])
    return y @ params["out_proj"], (h, new_conv)


def init_mamba_state(batch: int, d_model: int, *, expand: int, head_dim: int,
                     state: int, conv_width: int, dtype, device):
    d_inner, nheads, conv_dim = mamba_dims(d_model, expand, head_dim, state)
    h = torch.zeros((batch, nheads, head_dim, state), dtype=torch.float32,
                    device=device)
    conv = torch.zeros((batch, conv_width - 1, conv_dim), dtype=dtype,
                       device=device)
    return h, conv
