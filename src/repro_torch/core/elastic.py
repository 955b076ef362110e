"""Elastic Averaging SGD (paper §2.2, eqs. (2)/(3); ``repro/core/elastic.py``).

The PS stores *center variables* w̃. Every INTERVAL iterations a client
exchanges with the PS:

    server (Elastic1):  w̃ ← w̃ + α (w − w̃)        eq. (2)
    client (Elastic2):  w  ← w  − α (w − w̃_old)    eq. (3)

Both use the same pre-update difference (w − w̃).

Two substrates implement the exchange:

  per-leaf  a ``tree_map`` of the f32 update over every leaf — the
            readable reference
  flat      the whole pytree packed through ``core.flatbuf`` and ONE fused
            kernel pass: the PS tier's one-sided halves
            (``elastic_server_packed`` is the KVStore's Elastic1 rule,
            ``elastic_client_packed`` the client's Elastic2) with the
            packed wire form of a push (``wire_packed``), the C-client
            exchange (``elastic_exchange_multiclient_flat``), and the
            sharded cross-pod leg (``elastic_exchange_sharded``) that ring
            reduce-scatters the packed differences, so the exchange waits
            on (p−1)/p·n bytes instead of an allreduce's 2·(p−1)/p·n;
            and the one-pair exchange ``elastic_exchange_packed`` (both
            halves from one kernel pass, the pushed w first through the
            PS wire)

Every form returns new tensors and writes into none of its inputs: the
PS-tier runners start the center and every client replica from one tree,
and a client's Elastic2 reads the center as it was before its own push.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import comm as comm_lib, flatbuf
from repro_torch.core.collectives import check_wire_dtype
from repro_torch.kernels.fused_elastic.fused_elastic import (
    elastic_center_flat,
    elastic_client_diff_flat,
    elastic_client_flat,
    elastic_exchange_flat,
    elastic_exchange_flat_mc,
    elastic_server_flat,
)
from repro_torch.kernels.quant_bucket.quant_bucket import (
    dequantize_wire,
    quantize_wire,
)
from repro_torch.tree import tree_map


def _alpha(alpha, device) -> torch.Tensor:
    """α as the one f32 device value the kernels read (rounded from the
    Python float once, as the reference's ``jnp.asarray(α, f32)``)."""
    return torch.tensor(float(alpha), dtype=torch.float32, device=device)


def elastic_server_update(center: Any, client_params: Any, alpha: float) -> Any:
    """Eq. (2): move the center toward the client's params."""
    return tree_map(
        lambda c, w: (c.float() + alpha * (w.float() - c.float())).to(c.dtype),
        center, client_params)


def elastic_client_update(params: Any, center: Any, alpha: float) -> Any:
    """Eq. (3): pull the client's params toward the (old) center."""
    return tree_map(
        lambda w, c: (w.float() - alpha * (w.float() - c.float())).to(w.dtype),
        params, center)


def elastic_exchange(params: Any, center: Any, alpha: float) -> tuple[Any, Any]:
    """One full exchange: both updates computed from the same (w − w̃)."""
    new_center = elastic_server_update(center, params, alpha)
    new_params = elastic_client_update(params, center, alpha)
    return new_params, new_center


def elastic_exchange_multiclient(client_params: Any, center: Any,
                                 alpha: float) -> tuple[Any, Any]:
    """Exchange for params with a leading client dim C: the simultaneous
    EASGD generalization w̃ ← w̃ + α Σ_c (w_c − w̃); each client applies
    eq. (3) with the shared old center."""
    def server(c, w):
        c32 = c.float()
        return (c32 + alpha * (w.float() - c32).sum(0)).to(c.dtype)

    new_center = tree_map(server, center, client_params)
    new_params = tree_map(
        lambda w, c: (w.float() - alpha * (w.float() - c.float())).to(w.dtype),
        client_params, center)
    return new_params, new_center


# -- the PS tier's packed one-shot forms ------------------------------------

def _wire_roundtrip(buf: torch.Tensor, wire_dtype: Optional[str]) -> torch.Tensor:
    """The low-precision wire model on ONE packed buffer: what the
    receiving end of a compressed push sees. int8 is one
    ``quantize_wire`` and one ``dequantize_wire`` launch over the whole
    buffer; bf16 is a cast there and back."""
    wire = check_wire_dtype(wire_dtype, where="_wire_roundtrip")
    if wire is None:
        return buf
    if wire == "bf16":
        return buf.to(torch.bfloat16).to(buf.dtype)
    codes, scales = quantize_wire(buf)
    return dequantize_wire(codes, scales, buf.shape[0], buf.dtype)


def wire_packed(tree: Any, wire_dtype: Optional[str] = "int8") -> Any:
    """Wire roundtrip of the packed FlatBuffer: what a compressed PS push
    delivers to the server (the ONE packed buffer through the codec or a
    bf16 cast, not per-leaf codes)."""
    spec = flatbuf.spec_for(tree)
    return spec.unpack(_wire_roundtrip(spec.pack(tree), wire_dtype))


def elastic_client_packed(params: Any, center: Any, alpha) -> Any:
    """Eq. (3) only, on the packed FlatBuffer: the client's local half of
    the exchange (the server half runs in the PS tier), one fused pass."""
    spec_w, spec_c = flatbuf.spec_for(params), flatbuf.spec_for(center)
    w = spec_w.pack(params)
    new_w = elastic_client_flat(w, spec_c.pack(center), _alpha(alpha, w.device))
    return spec_w.unpack(new_w)


def elastic_server_packed(pushed: Any, center: Any, alpha) -> Any:
    """Eq. (2) only, on the packed FlatBuffer: the server rule applied to
    a pushed w — one fused pass, only the new center written."""
    spec_w, spec_c = flatbuf.spec_for(pushed), flatbuf.spec_for(center)
    c = spec_c.pack(center)
    new_c = elastic_server_flat(spec_w.pack(pushed), c, _alpha(alpha, c.device))
    return spec_c.unpack(new_c)


def scale_packed(tree: Any, factor) -> Any:
    """Scale a whole pytree as ONE packed buffer multiply by the f32
    ``factor`` (the staleness damping of the async server rule)."""
    spec = flatbuf.spec_for(tree)
    buf = spec.pack(tree)
    return spec.unpack(buf * torch.tensor(float(factor), dtype=torch.float32,
                                          device=buf.device))


def elastic_exchange_packed(params: Any, center: Any, alpha, *,
                            compress: bool = False,
                            wire_dtype: Optional[str] = None
                            ) -> tuple[Any, Any]:
    """Eqs. (2)+(3) on the WHOLE pytree as one packed FlatBuffer: pack w
    and w̃, run ONE fused kernel pass for both updates, unpack.

    ``wire_dtype`` ("bf16"/"int8") runs the packed w through the PS wire
    roundtrip first, so the exchange sees what a compressed push delivers.
    The removed ``compress=True`` alias is a hard error: it WAS
    ``wire_dtype="int8"``."""
    if compress:
        raise ValueError(
            "elastic_exchange_packed(compress=True) was removed — it is "
            "the int8 wire: pass wire_dtype='int8' instead")
    spec_w, spec_c = flatbuf.spec_for(params), flatbuf.spec_for(center)
    w = _wire_roundtrip(spec_w.pack(params), wire_dtype)
    c = spec_c.pack(center)
    new_w, new_c = elastic_exchange_flat(w, c, _alpha(alpha, c.device))
    return spec_w.unpack(new_w), spec_c.unpack(new_c)


def quantize_packed(tree: Any) -> Any:
    """Removed alias of the int8 packed wire roundtrip."""
    raise ValueError(
        "quantize_packed was removed — it is the int8 wire: call "
        "wire_packed(tree, wire_dtype='int8') instead")


def elastic_exchange_multiclient_flat(client_params: Any, center: Any, alpha,
                                      spec: Optional[flatbuf.FlatBuffer] = None
                                      ) -> tuple[Any, Any]:
    """Flat-substrate ``elastic_exchange_multiclient``: pack the C client
    replicas into one ``(C, size)`` buffer, run ONE fused kernel for every
    client's eq. (3) and the summed eq. (2) center move, unpack. ``spec``
    is the per-client param FlatBuffer (built from ``center`` when
    omitted)."""
    spec = spec or flatbuf.spec_for(center)
    w = spec.pack(client_params)
    c = spec.pack(center)
    new_w, new_c = elastic_exchange_flat_mc(w, c, _alpha(alpha, c.device))
    return spec.unpack(new_w), spec.unpack(new_c)


def elastic_exchange_sharded(spec: flatbuf.FlatBuffer, params: Any,
                             center: Any, alpha, *,
                             comm: comm_lib.Communicator = comm_lib.LOCAL
                             ) -> tuple[Any, Any]:
    """The cross-client exchange over the exchange group ``comm`` (the
    PS tier, e.g. ``world.split("pod")``); each member is one client and
    the center is replicated:

      1. pack w and w̃; ONE kernel pass computes eq. (3)'s new w AND the
         f32 difference (w − w̃)
      2. ring reduce-scatter the differences over the group
      3. fused eq. (2) kernel on each member's 1/p shard of the center
      4. ring allgather of the updated center shards

    The group's policy supplies the ring count, bucketing and the wire
    protocol. A trivial group degenerates to the local exchange: both
    kernels over the whole buffer, no collective. Under emulation the
    trees carry the world's leading device dims. Returns
    ``(new_params, new_center)``, both full trees.
    """
    p = comm.resolve_size()
    nr = comm.rings_for(spec.nbytes)
    _, total = flatbuf.shard_geometry(spec.size, p, nr)
    w = flatbuf.pack_padded(spec, params, total)
    c = flatbuf.pack_padded(spec, center, total)
    a = _alpha(alpha, w.device)

    new_w, diff = elastic_client_diff_flat(w, c, a)
    del w
    if p == 1:
        diff_sum, c_shard = diff, c
    else:
        diff_sum = comm.reduce_scatter(diff, num_rings=nr)
        c_shard = comm.shard_select(c, num_rings=nr)
    del diff, c
    new_c_shard = elastic_center_flat(c_shard, diff_sum, a)
    del diff_sum, c_shard
    new_c = (new_c_shard if p == 1
             else comm.allgather(new_c_shard, num_rings=nr))
    return (spec.unpack(new_w[..., :spec.size]),
            spec.unpack(new_c[..., :spec.size]))

