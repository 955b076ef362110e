"""Ring collectives over emulated devices, with the bf16/int8 wire.

Ports ``repro/core/collectives.py`` (lines 88-387): ``ring_reduce_scatter``,
``ring_allgather``, ``shard_select``, ``ring_allreduce``,
``tree_allreduce``, ``scatter_gather_allreduce``, ``allreduce``, and the
schedule-bucketed legs of backward overlap (``sched_reduce_scatter_bucket``,
``sched_reassemble``).

**Emulation backend.** The reference writes every algorithm against
``lax.ppermute`` over a named axis and runs it per device, under
``shard_map`` on a mesh or ``jax.vmap(..., axis_name=...)`` on one
device. PyTorch has no named-axis vmap, so here a group's per-device
values are ONE stacked tensor: its leading dims are the emulated world's
device axes (``(p, …)`` for one axis, ``(P, D, …)`` pod-major for two)
and its last dim is each device's flat payload. Every function takes the
stacked tensor and ``dim``, the leading dim of the ring's axis; the other
leading dims are independent rings run side by side. A forward
``ppermute`` (device i sends to i+1) is ``torch.roll(x, 1, dim)``, and a
per-device index such as ``(idx - s - 1) % p`` is one select per device.

The hops replay the reference's schedule in its order — the shifted
reduce-scatter sends chunk ``(idx-s-1)%p`` and accumulates the local
chunk ``(idx-s-2)%p`` — so f32 results equal the JAX emulation bit for
bit (``stack.sum(0)`` would reduce in another order).

**Wire protocol** (``wire_dtype``):

  None/"f32"  every hop sends the full-precision chunk
  "bf16"      each hop casts the outgoing chunk to bf16 (0.5x the bytes)
  "int8"      each hop sends int8 codes + one f32 scale per 128 values
              (``kernels.quant_bucket.wire_encode``, ~0.258x the bytes)

A reduce-scatter hop dequantizes what it receives and adds it to an f32
accumulator (dequant-accumulate-requant); an allgather encodes each shard
ONCE, forwards its codes verbatim, and the owner round-trips its own
shard through the codec too, so every device holds identical values. With
a wire the results are f32 whatever the input dtype.

A ``WireMeter`` passed as ``meter=`` counts the bytes each device puts on
the wire per hop (the ring family; ``psum`` and the binomial tree are not
byte-accounted), for holding the legs to ``core.cost_model``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.quant_bucket.quant_bucket import wire_decode, wire_encode

METHODS = ("ring", "multi_ring", "tree", "psum", "per_leaf", "scatter_gather")
#: wire dtypes of the low-precision protocol; None and "f32" are the
#: full-precision baseline
WIRE_DTYPES = (None, "f32", "bf16", "int8")
#: the methods whose explicit ring hops can carry a quantized wire
RING_METHODS = ("ring", "multi_ring", "scatter_gather")


def check_wire_dtype(wire_dtype, *, where: str) -> "str | None":
    """Validate + normalize a wire dtype ("f32" -> None)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"{where}: wire_dtype must be one of {WIRE_DTYPES}, "
            f"got {wire_dtype!r}")
    return None if wire_dtype == "f32" else wire_dtype


@dataclass
class WireMeter:
    """Bytes one device put on the wire, summed over hops."""

    bytes: int = 0

    def add(self, nbytes: int) -> None:
        self.bytes += int(nbytes)

    def reset(self) -> None:
        self.bytes = 0


def _payload_bytes(t: torch.Tensor) -> int:
    """One device's bytes of a stacked ``(…, m)`` message."""
    return t.shape[-1] * t.element_size()


def _permute(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The forward ring ppermute: device i receives device i-1's ``x``."""
    return torch.roll(x, 1, dim)


def _hop(x: torch.Tensor, dim: int, wire: Optional[str],
         meter: Optional[WireMeter]) -> torch.Tensor:
    """One forward ring hop of ``x`` under the wire protocol: the
    receiver's high-precision (f32) view of what crossed the wire."""
    if wire is None:
        _count(meter, x)
        return _permute(x, dim)
    if wire == "bf16":
        sent = x.to(torch.bfloat16)
        _count(meter, sent)
        return _permute(sent, dim).float()
    codes, scales = wire_encode(x)
    _count(meter, codes, scales)
    return wire_decode(_permute(codes, dim), _permute(scales, dim),
                       x.shape[-1])


def _count(meter: Optional[WireMeter], *parts: torch.Tensor) -> None:
    if meter is not None:
        meter.add(sum(_payload_bytes(t) for t in parts))


def _take(b: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """Device i (along ``dim``) takes chunk ``(i - k) % p`` of its
    ``(…, p, chunk)`` view ``b``: -> ``(…, chunk)``."""
    p = b.shape[dim]
    return torch.stack([b.select(dim, i).select(-2, (i - k) % p)
                        for i in range(p)], dim)


def _put(out: torch.Tensor, dim: int, k: int, val: torch.Tensor) -> None:
    """Device i writes its ``val`` into chunk ``(i - k) % p`` of its
    ``(…, p, chunk)`` view ``out`` (in place)."""
    p = out.shape[dim]
    for i in range(p):
        out.select(dim, i).select(-2, (i - k) % p).copy_(val.select(dim, i))


def _pad_to(x: torch.Tensor, total: int) -> torch.Tensor:
    n = x.shape[-1]
    return F.pad(x, (0, total - n)) if total > n else x


def ring_reduce_scatter(x: torch.Tensor, dim: int, *, num_rings: int = 1,
                        wire_dtype: "str | None" = None,
                        meter: Optional[WireMeter] = None) -> torch.Tensor:
    """Each device ends with its own fully-reduced 1/p slice of ``x``
    (``(…, n)`` stacked): -> ``(…, R*chunk)``.

    With ``num_rings = R > 1`` the buffer splits into R independent ring
    schedules (layout ``(R, p, chunk)``) and the local shard is the R
    per-ring chunks raveled — the selection ``shard_select`` makes and
    ``ring_allgather(num_rings=R)`` inverts."""
    wire = check_wire_dtype(wire_dtype, where="ring_reduce_scatter")
    p = x.shape[dim]
    n = x.shape[-1]
    nr = max(1, num_rings)
    chunk = -(-n // (p * nr))
    flat = _pad_to(x, chunk * p * nr)
    if p == 1:
        return flat
    lead = tuple(x.shape[:-1])
    bufs = flat.reshape(lead + (nr, p, chunk))
    acc: list = [None] * nr
    # shifted schedule so device i ends owning chunk i of every ring
    for s in range(p - 1):
        for r in range(nr):
            ring = bufs.select(-3, r)
            send = _take(ring, dim, s + 1) if s == 0 else acc[r]
            recv = _hop(send, dim, wire, meter)
            local = _take(ring, dim, s + 2)
            if wire is not None:
                local = local.float()   # hp accumulator
            acc[r] = local + recv
    if nr == 1:
        return acc[0]
    return torch.stack(acc, -2).reshape(lead + (nr * chunk,))


def ring_allgather(x: torch.Tensor, dim: int, *, num_rings: int = 1,
                   wire_dtype: "str | None" = None,
                   meter: Optional[WireMeter] = None) -> torch.Tensor:
    """Inverse of reduce-scatter: gather the per-device ``(…, R*chunk)``
    shards to the full ``(…, R*p*chunk)`` buffer (ring-major layout).

    With a wire each shard is encoded ONCE and its codes forwarded
    verbatim; the owner round-trips its own shard through the codec too,
    so every device reconstructs identical buffers. The result is f32."""
    wire = check_wire_dtype(wire_dtype, where="ring_allgather")
    p = x.shape[dim]
    nr = max(1, num_rings)
    if p == 1:
        return x if wire is None else x.float()
    lead = tuple(x.shape[:-1])
    chunk = x.shape[-1] // nr
    shards = x.reshape(lead + (nr, chunk))
    outs, cur = [], []
    for r in range(nr):
        shard = shards.select(-2, r)
        if wire is None:
            own = wired = shard
        elif wire == "bf16":
            wired = shard.to(torch.bfloat16)
            own = wired.float()
        else:
            wired = wire_encode(shard)   # (codes, scales)
            own = wire_decode(*wired, chunk)
        out = own.new_zeros(lead + (p, chunk))
        _put(out, dim, 0, own)
        outs.append(out)
        cur.append(wired)
    for s in range(p - 1):
        for r in range(nr):
            if wire == "int8":
                _count(meter, *cur[r])
                nxt = tuple(_permute(t, dim) for t in cur[r])
                val = wire_decode(*nxt, chunk)
            else:
                _count(meter, cur[r])
                nxt = _permute(cur[r], dim)
                val = nxt if wire is None else nxt.float()
            _put(outs[r], dim, s + 1, val)
            cur[r] = nxt
    if nr == 1:
        return outs[0].reshape(lead + (-1,))
    return torch.stack(outs, -3).reshape(lead + (-1,))


def shard_select(flat: torch.Tensor, dim: int, *,
                 num_rings: int = 1) -> torch.Tensor:
    """Each device's shard of a *replicated* ``(…, n)`` buffer — exactly
    the slice ``ring_reduce_scatter`` with the same geometry leaves
    there. ``n`` must divide by ``p * num_rings``."""
    p = flat.shape[dim]
    nr = max(1, num_rings)
    if p == 1:
        return flat
    lead = tuple(flat.shape[:-1])
    chunk = flat.shape[-1] // (p * nr)
    b = flat.reshape(lead + (nr, p, chunk))
    sel = torch.stack([b.select(dim, i).select(-2, i) for i in range(p)], dim)
    return sel.reshape(lead + (nr * chunk,))


def ring_allreduce(x: torch.Tensor, dim: int, *, num_rings: int = 1,
                   meter: Optional[WireMeter] = None) -> torch.Tensor:
    """Bucket-algorithm allreduce (sum) of the stacked ``(…, n)`` ``x``:
    ring reduce-scatter then ring allgather, in place in the R ring
    layouts, every device ending with the whole sum."""
    p = x.shape[dim]
    if p == 1:
        return x
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    nr = max(1, num_rings)
    chunk = -(-n // (p * nr))
    bufs = _pad_to(x, chunk * p * nr).reshape(lead + (nr, p, chunk))
    acc: list = [None] * nr
    for s in range(p - 1):
        for r in range(nr):
            ring = bufs.select(-3, r)
            send = _take(ring, dim, s) if s == 0 else acc[r]
            recv = _hop(send, dim, None, meter)
            acc[r] = _take(ring, dim, s + 1) + recv
    outs = []
    for r in range(nr):
        out = bufs.select(-3, r).clone()
        _put(out, dim, -1, acc[r])       # row (idx + 1) % p
        outs.append(out)
    cur = list(acc)
    for s in range(p - 1):
        for r in range(nr):
            nxt = _hop(cur[r], dim, None, meter)
            _put(outs[r], dim, s, nxt)   # row (idx - s) % p
            cur[r] = nxt
    return torch.stack(outs, -3).reshape(lead + (-1,))[..., :n]


def tree_allreduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Binomial reduce to rank 0 + binomial broadcast (the `reg`
    baseline and the PS push/pull pattern); p a power of two."""
    p = x.shape[dim]
    if p == 1:
        return x
    if p & (p - 1):
        raise ValueError(f"tree_allreduce requires a power-of-two axis, got {p}")
    d = 1
    while d < p:
        recv = torch.zeros_like(x)
        for j in range(0, p, 2 * d):          # j receives from j + d
            recv.select(dim, j).copy_(x.select(dim, j + d))
        x = x + recv
        d *= 2
    d //= 2
    while d >= 1:
        x = x.clone()
        for j in range(d, p, 2 * d):          # j receives from j - d
            x.select(dim, j).copy_(x.select(dim, j - d))
        d //= 2
    return x


def scatter_gather_allreduce(x: torch.Tensor, dim: int, *, num_rings: int = 1,
                             wire_dtype: "str | None" = None,
                             meter: Optional[WireMeter] = None) -> torch.Tensor:
    """Allreduce as its two explicit halves (reduce-scatter + allgather),
    each carrying the ``wire_dtype`` protocol; in ``x``'s dtype."""
    p = x.shape[dim]
    if p == 1:
        return x
    n = x.shape[-1]
    nr = max(1, num_rings)
    shard = ring_reduce_scatter(x, dim, num_rings=nr, wire_dtype=wire_dtype,
                                meter=meter)
    full = ring_allgather(shard, dim, num_rings=nr, wire_dtype=wire_dtype,
                          meter=meter)
    return full[..., :n].to(x.dtype)


def allreduce(x: torch.Tensor, dim: int, method: str = "ring", *,
              num_rings: int = 2, meter: Optional[WireMeter] = None
              ) -> torch.Tensor:
    """Sum of the stacked ``(…, n)`` ``x`` over ``dim`` by ``method``."""
    if method == "psum":
        return x.sum(dim, keepdim=True).expand(x.shape).clone()
    if method == "ring":
        return ring_allreduce(x, dim, num_rings=1, meter=meter)
    if method == "multi_ring":
        return ring_allreduce(x, dim, num_rings=num_rings, meter=meter)
    if method == "tree":
        return tree_allreduce(x, dim)
    if method == "scatter_gather":
        return scatter_gather_allreduce(x, dim, num_rings=num_rings,
                                        meter=meter)
    raise ValueError(f"unknown allreduce method {method!r}")


# --------------------------------------------------------------------------
# Schedule-bucketed legs (backward overlap)
# --------------------------------------------------------------------------
#
# A ``flatbuf.BucketSchedule`` partitions the packed buffer at stage
# boundaries; each bucket gets its OWN single-ring reduce-scatter leg so
# the grad fn can issue bucket b's leg while earlier-in-forward stages are
# still differentiating. One trailing allgather moves the whole updated
# shard, and ``sched_reassemble`` re-stitches the device-major gather into
# the packed layout. Multi-axis (pod×data) nesting lives on
# ``Communicator.reduce_scatter_bucket`` / ``allgather_sched``.

def sched_reduce_scatter_bucket(seg: torch.Tensor, dim: int, schedule,
                                b: int, *, wire_dtype: "str | None" = None,
                                meter: Optional[WireMeter] = None
                                ) -> torch.Tensor:
    """One schedule bucket's ring reduce-scatter leg over one axis.

    ``seg`` is bucket ``b``'s stacked ``(…, sizes[b])`` segment (or its
    already padded ``(…, p*chunks[b])`` form); returns each device's
    fully-reduced ``(…, chunks[b])`` chunk. Single-ring on purpose: the
    schedule buckets are the overlap units."""
    return ring_reduce_scatter(_pad_to(seg, schedule.bucket_padded(b)), dim,
                               num_rings=1, wire_dtype=wire_dtype,
                               meter=meter)


def sched_reassemble(gathered: torch.Tensor, schedule) -> torch.Tensor:
    """Invert the scheduled allgather: ``gathered`` is the device-major
    ``(…, p * shard_size)`` concatenation of per-device schedule shards
    (each the bucket-major concat of its per-bucket chunks); returns the
    ``(…, spec.size)`` packed buffer. Static slices, one copy."""
    m = schedule.shard_size
    out = gathered.new_empty(tuple(gathered.shape[:-1])
                             + (schedule.spec.size,))
    for b, off in enumerate(schedule.shard_offsets):
        cb, start, size = schedule.chunks[b], schedule.starts[b], schedule.sizes[b]
        for d in range(schedule.p):
            lo, hi = d * cb, min((d + 1) * cb, size)
            if lo >= hi:
                break
            src = d * m + off
            out[..., start + lo:start + hi] = gathered[..., src:src + hi - lo]
    return out


# --------------------------------------------------------------------------
# Tensor (fused-pytree) collectives as free functions
# --------------------------------------------------------------------------
#
# The canonical spelling is ``Communicator.tensor_allreduce`` /
# ``Communicator.pushpull`` (core/comm.py): the group owns its whole
# ``CollectivePolicy``. These wrappers take a Communicator only, with the
# reference's refusals (``repro/core/collectives.py:418-460``).

def _as_group(group, method, num_rings, wire_dtype, *, where: str):
    from repro_torch.core.comm import Communicator

    if not isinstance(group, Communicator):
        raise ValueError(
            f"{where}: the axis_name= string form was removed — build the "
            "group with Communicator.world(axes, sizes) and pass it instead, "
            f"got {group!r}")
    if method is not None or num_rings is not None or wire_dtype is not None:
        raise ValueError(
            f"{where}: with a Communicator the collective policy lives on "
            "the group — set method/num_rings/wire_dtype there "
            "(Communicator.with_policy), not as arguments")
    return group


def tensor_allreduce(tree, axis_name, method: Optional[str] = None, *,
                     num_rings: Optional[int] = None,
                     wire_dtype: Optional[str] = None, mean: bool = False,
                     spec=None):
    """Allreduce a stacked pytree as ONE fused buffer over the group
    ``axis_name`` (a ``core.comm.Communicator``; its leading dims are the
    group's frame)."""
    group = _as_group(axis_name, method, num_rings, wire_dtype,
                      where="tensor_allreduce")
    return group.tensor_allreduce(tree, mean=mean, spec=spec)


def tensor_pushpull(tree, axis_name, *, fused: bool = True,
                    method: Optional[str] = None,
                    num_rings: Optional[int] = None,
                    wire_dtype: Optional[str] = None, spec=None):
    """The KVStore.pushpull pattern inside the group: ``fused=True`` is one
    tensor allreduce (mean); ``fused=False`` is a tree push + tree pull,
    so ``method`` must be left unset (or "tree") there."""
    if not fused and method not in (None, "tree"):
        raise ValueError(
            f"method={method!r} is only meaningful for fused=True; the "
            "unfused path is defined as tree push + tree pull")
    group = _as_group(axis_name, method, num_rings, wire_dtype,
                      where="tensor_pushpull")
    return group.pushpull(tree, fused=fused, spec=spec)
