"""Mixture-of-Experts block (``repro/models/moe.py``): top-k router, shared
+ routed experts, capacity-based sort/scatter dispatch (exact active
FLOPs, no dense all-experts compute), load-balance auxiliary loss.

Expert weights are stacked ``(L, E, d, f)`` per layer stack, as the
reference's. Dispatch is per batch row (capacity ∝ S). On a DTensor mesh
(the GSPMD path) each rank routes and dispatches its own batch rows
(``sharding.rules.local_rows``), so its slots and keeps are the
one-process ones; the expert buffers carry the reference's hint
(``expert_hint``: E on 'expert', the B·C rows on the data axes), the
expert product runs on them as DTensors, and the reshard after it
gathers each rank's rows of every expert over 'expert'
(``local_expert_rows``). The aux loss's means over (B, S) are DTensor
reductions over the data axes. On plain tensors every hint is the
identity.

Every step is deterministic on the CPU and on the card, and none waits
for the device (capacity from Python ints, masks by ``torch.where``):

- the top-k breaks ties toward the lower expert index, as
  ``jax.lax.top_k`` (a stable descending sort, not ``torch.topk``);
- the dispatch scatter adds each kept entry into its own slot of the
  ``(E, B·C, d)`` expert buffers; a dropped entry adds a zero into slot
  ``C - 1`` — exact in any order;
- the combine adds the K weighted expert outputs of a token in k order
  (``0 + g_0 = g_0``: the reference's sequential scatter-add, bit for bit)
  instead of an atomic scatter.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, ffn, init_ffn
from repro_torch.sharding.rules import (expert_buffer, expert_hint, local_expert_rows,
                                        local_replica, local_rows, rows_like)


def init_moe(gen, d_model: int, num_experts: int, num_shared: int,
             moe_d_ff: int, dtype, device, layers: int) -> dict:
    """MoE weights for ``layers`` stacked blocks; the router is f32."""
    L, E, d, f = layers, num_experts, d_model, moe_d_ff
    p = {
        "router": dense_init(gen, d, (L, d, E), torch.float32, device),
        "moe_gate": dense_init(gen, d, (L, E, d, f), dtype, device),
        "moe_up": dense_init(gen, d, (L, E, d, f), dtype, device),
        "moe_down": dense_init(gen, f, (L, E, f, d), dtype, device),
    }
    if num_shared:
        # shared experts fused into one wide always-on FFN
        p["shared"] = init_ffn(gen, d, num_shared * f, dtype, device, L)
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, ties to the
    lower index (a stable descending sort keeps equal values in index
    order)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(probs, -1, idx), idx


def _dispatch_indices(expert_idx: torch.Tensor, num_experts: int,
                      capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """expert_idx: (..., T*K) flat expert assignments. Returns (slot,
    keep): each entry's position in its expert's arrival order and
    whether it fits the capacity."""
    tk = expert_idx.shape[-1]
    dev = expert_idx.device
    e = expert_idx.long()
    order = torch.argsort(e, dim=-1, stable=True)
    sorted_e = torch.gather(e, -1, order)
    experts = torch.arange(num_experts, device=dev).expand(
        sorted_e.shape[:-1] + (num_experts,)).contiguous()
    starts = torch.searchsorted(sorted_e.contiguous(), experts, side="left")
    pos_in_e = torch.arange(tk, device=dev) - torch.gather(starts, -1, sorted_e)
    # invert the sort: per-(token, k) slot and keep
    slot = torch.zeros_like(e).scatter(-1, order, pos_in_e).to(torch.int32)
    keep = torch.zeros_like(e, dtype=torch.bool).scatter(-1, order,
                                                         pos_in_e < capacity)
    return slot, keep


def moe_block(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float, aux_weight: float,
              deterministic_capacity: Optional[int] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out, aux_loss)."""
    _, S, d = x.shape
    E, K = num_experts, top_k
    capacity = deterministic_capacity or max(
        K, int(math.ceil(S * K * capacity_factor / E)))
    # routing and dispatch are per batch row: on a mesh, this rank's rows
    xl = local_rows(x)
    Bl, dev = xl.shape[0], xl.device
    logits = xl.float() @ local_replica(params["router"], x)  # (Bl, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, K)                           # (Bl, S, K)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    flat_e = top_e.reshape(Bl, S * K)
    slot, keep = _dispatch_indices(flat_e, E, capacity)
    safe_slot = torch.where(keep, slot, capacity - 1).long()
    # row (e, b, slot) of the expert buffers, laid out (E, B·C, d) so each
    # expert's tokens of every row are one operand of its product
    rows = ((flat_e.long() * Bl + torch.arange(Bl, device=dev)[:, None])
            * capacity + safe_slot).reshape(-1)

    # scatter into the buffers (drops add zeros); x[:, tok_ids] as an
    # expand, so its backward sums each token's K terms deterministically
    xk = xl[:, :, None, :].expand(Bl, S, K, d).reshape(Bl, S * K, d)
    vals = torch.where(keep[..., None], xk, torch.zeros((), dtype=x.dtype,
                                                        device=dev))
    buf = torch.zeros((E * Bl * capacity, d), dtype=x.dtype, device=dev)
    buf = buf.index_add(0, rows, vals.reshape(-1, d)).reshape(E, Bl * capacity, d)
    buf = expert_buffer(buf, x)

    # grouped expert FFN, the reference's einsum "becd,edf->becf": one
    # batched product over E, each expert's weights read once (a (B, E, C,
    # d) @ (E, d, f) matmul would copy the weights B times to broadcast)
    g = buf @ params["moe_gate"]
    u = buf @ params["moe_up"]
    y = expert_hint((F.silu(g) * u) @ params["moe_down"], x)  # (E, B·C, d)

    # gather back, weight by router prob, sum over k in k order
    y = local_expert_rows(y, x)
    gathered = y.reshape(E * Bl * capacity, d).index_select(0, rows)
    gathered = torch.where(keep.reshape(-1, 1), gathered,
                           torch.zeros((), dtype=x.dtype, device=dev))
    w = top_p.reshape(Bl * S * K, 1).to(x.dtype)
    terms = (gathered * w).reshape(Bl, S, K, d)
    out = terms[:, :, 0]
    for k in range(1, K):
        out = out + terms[:, :, k]
    out = rows_like(out, x)

    if "shared" in params:
        out = out + ffn(params["shared"], x)

    hit = (top_e[..., None] == torch.arange(E, device=dev)).any(dim=2)
    frac_tokens = torch.mean(rows_like(hit.float(), x), dim=(0, 1))
    frac_probs = torch.mean(rows_like(probs, x), dim=(0, 1))
    aux = aux_weight * E * torch.sum(frac_tokens * frac_probs)
    return out, aux


def reference_moe(params: dict, x: torch.Tensor, *, num_experts: int,
                  top_k: int) -> torch.Tensor:
    """Dense oracle: every expert on every token, no capacity drops."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    top_p, top_e = _top_k(probs, top_k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    g = torch.einsum("td,edf->etf", xt, params["moe_gate"])
    u = torch.einsum("td,edf->etf", xt, params["moe_up"])
    y = torch.einsum("etf,efd->etd", F.silu(g) * u, params["moe_down"])
    w = torch.zeros((xt.shape[0], num_experts), dtype=torch.float32,
                    device=x.device).scatter_add(1, top_e, top_p)
    out = torch.einsum("te,etd->td", w.to(x.dtype), y)
    if "shared" in params:
        out = out + ffn(params["shared"], xt)
    return out.reshape(B, S, d)
