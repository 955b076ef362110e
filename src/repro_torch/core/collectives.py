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

An int8 reduce-scatter encodes its first send once; every later hop
dequantizes what it receives, adds the local chunk in f32 and requantizes
the sum for the next hop in ONE call (``wire_decode_add_encode``), and the
last hop keeps the f32 sum. An allgather encodes each shard ONCE, forwards
its codes verbatim, and the owner round-trips its own shard through the
codec too, so every device holds identical values. With a wire the
results are f32 whatever the input dtype.

The per-hop codec is a hand-written CUDA C++ kernel on the card
(``csrc/wire_hop.cu``: the fusion XLA makes of the reference's inline
``jnp`` codec) and its plain PyTorch version on the CPU; both compute the
reference's eager arithmetic, so the codes, scales and sums are the same
bit for bit.

A ``WireMeter`` passed as ``meter=`` counts the bytes each device puts on
the wire per hop (the ring family; ``psum`` and the binomial tree are not
byte-accounted), for holding the legs to ``core.cost_model``.

**Process backend.** The same functions run in a world of one process per
device (``launch/mesh.py``): ``dim`` is then a ``RankAxis``, and each rank
holds only its own block, whose world dims have size 1. Only the steps
that carry device identity change form — the forward permute becomes one
``torch.distributed`` P2P exchange inside the axis' process group (send
to coordinate i+1, receive from i-1; the int8 wire's codes and scales as
two messages), a per-device chunk index becomes this rank's coordinate,
and ``psum`` gathers every member's block and reduces the gathered stack
exactly as the emulated backend reduces its own. The hop schedule, the
f32 accumulators, the codec calls and the ``WireMeter`` counts are the
emulated backend's code, so the results are bit for bit the same.

Under gloo, whose send and receive take host memory, a card tensor is
staged: copied to pinned host memory, sent or received there, and copied
back to the card. That is the transport of a gloo world on one card, not
a fallback; ``Link.stats`` counts the staged bytes and times the copies
and the exchange beside the ``WireMeter``. Under NCCL (one card a rank)
card tensors go directly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.quant_bucket.quant_bucket import (
    wire_decode, wire_decode_add_encode, wire_encode)

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


@dataclass
class LinkStats:
    """What a rank's ``Link`` moved and how long it took, summed over
    exchanges: the bytes staged device -> host and host -> device (0 when
    nothing is staged) and the seconds of those copies and of the
    send / receive itself; ``by_op`` splits the staged bytes (both ways)
    by the collective that moved them, where the GSPMD path names it
    (``sharding.staging``)."""

    messages: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    d2h_s: float = 0.0
    h2d_s: float = 0.0
    p2p_s: float = 0.0
    by_op: dict = field(default_factory=dict)

    def reset(self) -> None:
        self.__init__()


@dataclass
class Link:
    """How one rank's messages cross a process world: ``torch.distributed``
    P2P and all-gather over ``backend`` ("gloo" or "nccl"). Under gloo a
    tensor on the card is staged through pinned host memory (the module
    docstring); ``stats`` counts what moved."""

    backend: str
    device: torch.device
    stats: LinkStats = field(default_factory=LinkStats)

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.stats.d2h_s += time.perf_counter() - t0
        self.stats.d2h_bytes += host.numel() * host.element_size()
        return host

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out = host.to(self.device)
        torch.cuda.synchronize(self.device)
        self.stats.h2d_s += time.perf_counter() - t0
        self.stats.h2d_bytes += host.numel() * host.element_size()
        return out

    def exchange(self, sends: Sequence[tuple[torch.Tensor, int]],
                 recvs: Sequence[tuple[torch.Tensor, int]]
                 ) -> list[torch.Tensor]:
        """One batch of P2P messages: ``sends`` are (tensor, global peer),
        ``recvs`` (a tensor shaped and typed as the message, global peer);
        the i-th message to or from one peer pairs with the i-th of the
        other side (tag i). Returns the received tensors, on the device."""
        if not sends and not recvs:
            return []
        out_bufs = [t.contiguous() for t, _ in sends]
        if self.staged:
            out_bufs = [self._to_host(t) for t in out_bufs]
            in_bufs = [torch.empty(like.shape, dtype=like.dtype,
                                   pin_memory=True) for like, _ in recvs]
        else:
            in_bufs = [torch.empty(like.shape, dtype=like.dtype,
                                   device=like.device) for like, _ in recvs]
        ops, tag_of = [], {}
        for i, (_, peer) in enumerate(sends):
            tag_of[peer] = tag_of.get(peer, -1) + 1
            ops.append(dist.P2POp(dist.isend, out_bufs[i], peer,
                                  tag=tag_of[peer]))
        tag_of = {}
        for i, (_, peer) in enumerate(recvs):
            tag_of[peer] = tag_of.get(peer, -1) + 1
            ops.append(dist.P2POp(dist.irecv, in_bufs[i], peer,
                                  tag=tag_of[peer]))
        t0 = time.perf_counter()
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.stats.p2p_s += time.perf_counter() - t0
        self.stats.messages += len(ops)
        if self.staged:
            in_bufs = [self._to_device(t) for t in in_bufs]
        return in_bufs

    def all_gather(self, x: torch.Tensor, group) -> list[torch.Tensor]:
        """Every member's ``x`` of ``group``, in group-rank order."""
        t = x.contiguous()
        if self.staged:
            t = self._to_host(t)
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        t0 = time.perf_counter()
        dist.all_gather(parts, t, group=group)
        self.stats.p2p_s += time.perf_counter() - t0
        self.stats.messages += len(parts)
        if self.staged:
            parts = [self._to_device(p) for p in parts]
        return parts


@dataclass(frozen=True)
class _Stacked:
    """An emulated axis: the stacked dim ``dim`` holds all ``size``
    members."""

    dim: int
    size: int

    def permute(self, *xs: torch.Tensor) -> tuple:
        """The forward ring ppermute: member i receives member i-1's."""
        return tuple(torch.roll(x, 1, self.dim) for x in xs)

    def ppermute(self, x: torch.Tensor, pairs, *, keep: bool = False
                 ) -> torch.Tensor:
        """Member ``dst`` receives member ``src``'s ``x`` for each (src,
        dst) pair; the others hold zeros (``keep``: their own ``x``)."""
        out = x.clone() if keep else torch.zeros_like(x)
        for src, dst in pairs:
            out.select(self.dim, dst).copy_(x.select(self.dim, src))
        return out

    def take(self, b: torch.Tensor, k: int) -> torch.Tensor:
        """Member i takes chunk ``(i - k) % p`` of its ``(…, p, chunk)``
        view ``b``: -> ``(…, chunk)``."""
        p = self.size
        return torch.stack([b.select(self.dim, i).select(-2, (i - k) % p)
                            for i in range(p)], self.dim)

    def put(self, out: torch.Tensor, k: int, val: torch.Tensor) -> None:
        """Member i writes its ``val`` into chunk ``(i - k) % p`` of its
        ``(…, p, chunk)`` view ``out`` (in place)."""
        for i in range(self.size):
            out.select(self.dim, i).select(-2, (i - k) % self.size).copy_(
                val.select(self.dim, i))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` with the axis' dim holding every member: ``x`` itself."""
        return x


@dataclass(frozen=True)
class RankAxis:
    """One axis of a process world as this rank sees it: the axis' leading
    dim in the rank's block (of size 1), the axis size, this rank's
    coordinate, the axis' process group (group rank == coordinate) and
    the ``Link`` its messages cross."""

    dim: int
    size: int
    coord: int
    group: Any
    link: Link = field(compare=False)

    def _peer(self, coord: int) -> int:
        return dist.get_global_rank(self.group, coord % self.size)

    def permute(self, *xs: torch.Tensor) -> tuple:
        """The forward ring ppermute: send to coordinate i+1, receive
        from i-1, every tensor of ``xs`` a message of its own."""
        nxt, prv = self._peer(self.coord + 1), self._peer(self.coord - 1)
        return tuple(self.link.exchange([(x, nxt) for x in xs],
                                        [(x, prv) for x in xs]))

    def ppermute(self, x: torch.Tensor, pairs, *, keep: bool = False
                 ) -> torch.Tensor:
        sends = [(x, self._peer(d)) for s, d in pairs if s == self.coord]
        srcs = [s for s, d in pairs if d == self.coord]
        got = self.link.exchange(sends, [(x, self._peer(s)) for s in srcs])
        if got:
            return got[0]
        return x if keep else torch.zeros_like(x)

    def take(self, b: torch.Tensor, k: int) -> torch.Tensor:
        return b.select(-2, (self.coord - k) % self.size)

    def put(self, out: torch.Tensor, k: int, val: torch.Tensor) -> None:
        out.select(-2, (self.coord - k) % self.size).copy_(val)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` with the axis' dim holding every member, in coordinate
        order: the stacked value the emulated backend holds."""
        return torch.cat(self.link.all_gather(x, self.group), self.dim)


def _axis(x: torch.Tensor, dim) -> "_Stacked | RankAxis":
    """The axis ``dim`` names for ``x``: an int is the emulated stacked
    dim, a ``RankAxis`` stands as it is."""
    return _Stacked(dim, x.shape[dim]) if isinstance(dim, int) else dim


def gather_members(x: torch.Tensor, axes: Sequence[RankAxis], group,
                   link: Link) -> torch.Tensor:
    """``x`` with the dims of ``axes`` (a process group's axes, outermost
    first; ``group`` their flattened group) holding every member: one
    all-gather, re-stacked as the emulated frame stacks them."""
    parts = link.all_gather(x, group)
    for ax in reversed(axes):
        parts = [torch.cat(parts[i:i + ax.size], ax.dim)
                 for i in range(0, len(parts), ax.size)]
    return parts[0]


def _hop(x: torch.Tensor, ax, wire: Optional[str],
         meter: Optional[WireMeter]) -> torch.Tensor:
    """One forward ring hop of ``x`` over the f32 or bf16 wire: the
    receiver's view of what crossed it (f32 for bf16). The int8 hop is
    ``ring_reduce_scatter``'s own: it fuses the decode into the next
    encode."""
    if wire is None:
        _count(meter, x)
        return ax.permute(x)[0]
    sent = x.to(torch.bfloat16)
    _count(meter, sent)
    return ax.permute(sent)[0].float()


def _count(meter: Optional[WireMeter], *parts: torch.Tensor) -> None:
    if meter is not None:
        meter.add(sum(_payload_bytes(t) for t in parts))


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
    ax = _axis(x, dim)
    p = ax.size
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
            local = ax.take(ring, s + 2)
            if wire == "int8":
                # acc holds the (codes, scales) this step sends; the last
                # step keeps the f32 sum (hp accumulator)
                sent = wire_encode(ax.take(ring, s + 1)) if s == 0 else acc[r]
                _count(meter, *sent)
                acc[r] = wire_decode_add_encode(*ax.permute(*sent), local, chunk,
                                                last=s == p - 2)
                continue
            send = ax.take(ring, s + 1) if s == 0 else acc[r]
            recv = _hop(send, ax, wire, meter)
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
    ax = _axis(x, dim)
    p = ax.size
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
        ax.put(out, 0, own)
        outs.append(out)
        cur.append(wired)
    for s in range(p - 1):
        for r in range(nr):
            if wire == "int8":
                _count(meter, *cur[r])
                nxt = ax.permute(*cur[r])
                val = wire_decode(*nxt, chunk)
            else:
                _count(meter, cur[r])
                nxt = ax.permute(cur[r])[0]
                val = nxt if wire is None else nxt.float()
            ax.put(outs[r], s + 1, val)
            cur[r] = nxt
    if nr == 1:
        return outs[0].reshape(lead + (-1,))
    return torch.stack(outs, -3).reshape(lead + (-1,))


def shard_select(flat: torch.Tensor, dim: int, *,
                 num_rings: int = 1) -> torch.Tensor:
    """Each device's shard of a *replicated* ``(…, n)`` buffer — exactly
    the slice ``ring_reduce_scatter`` with the same geometry leaves
    there. ``n`` must divide by ``p * num_rings``."""
    ax = _axis(flat, dim)
    p = ax.size
    nr = max(1, num_rings)
    if p == 1:
        return flat
    lead = tuple(flat.shape[:-1])
    chunk = flat.shape[-1] // (p * nr)
    sel = ax.take(flat.reshape(lead + (nr, p, chunk)), 0)
    return sel.reshape(lead + (nr * chunk,))


def ring_allreduce(x: torch.Tensor, dim: int, *, num_rings: int = 1,
                   meter: Optional[WireMeter] = None) -> torch.Tensor:
    """Bucket-algorithm allreduce (sum) of the stacked ``(…, n)`` ``x``:
    ring reduce-scatter then ring allgather, in place in the R ring
    layouts, every device ending with the whole sum."""
    ax = _axis(x, dim)
    p = ax.size
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
            send = ax.take(ring, s) if s == 0 else acc[r]
            recv = _hop(send, ax, None, meter)
            acc[r] = ax.take(ring, s + 1) + recv
    outs = []
    for r in range(nr):
        out = bufs.select(-3, r).clone()
        ax.put(out, -1, acc[r])          # row (idx + 1) % p
        outs.append(out)
    cur = list(acc)
    for s in range(p - 1):
        for r in range(nr):
            nxt = _hop(cur[r], ax, None, meter)
            ax.put(outs[r], s, nxt)      # row (idx - s) % p
            cur[r] = nxt
    return torch.stack(outs, -3).reshape(lead + (-1,))[..., :n]


def tree_allreduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Binomial reduce to rank 0 + binomial broadcast (the `reg`
    baseline and the PS push/pull pattern); p a power of two."""
    ax = _axis(x, dim)
    p = ax.size
    if p == 1:
        return x
    if p & (p - 1):
        raise ValueError(f"tree_allreduce requires a power-of-two axis, got {p}")
    d = 1
    while d < p:                              # j receives from j + d
        x = x + ax.ppermute(x, [(j + d, j) for j in range(0, p, 2 * d)])
        d *= 2
    d //= 2
    while d >= 1:                             # j receives from j - d
        x = ax.ppermute(x, [(j - d, j) for j in range(d, p, 2 * d)],
                        keep=True)
        d //= 2
    return x


def scatter_gather_allreduce(x: torch.Tensor, dim: int, *, num_rings: int = 1,
                             wire_dtype: "str | None" = None,
                             meter: Optional[WireMeter] = None) -> torch.Tensor:
    """Allreduce as its two explicit halves (reduce-scatter + allgather),
    each carrying the ``wire_dtype`` protocol; in ``x``'s dtype."""
    p = _axis(x, dim).size
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
        ax = _axis(x, dim)
        return ax.gather(x).sum(ax.dim, keepdim=True).expand(x.shape).clone()
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


def _selftest_rank(mesh, x) -> dict:
    """One rank of ``_selftest``: every allreduce method over its row."""
    ax = mesh.rank_axis("ring", 0)
    mine = x[mesh.index:mesh.index + 1].to(mesh.device)
    return {m: allreduce(mine, ax, m) for m in
            ("ring", "multi_ring", "tree", "psum", "scatter_gather")}


def _selftest(p: int = 8, device="cuda") -> None:  # pragma: no cover
    """Every allreduce method against the plain sum, emulated on
    ``device``, then over a process mesh of p gloo ranks on ``device``,
    where each rank's result must equal the emulated one exactly."""
    import numpy as np

    from repro_torch.launch.mesh import spawn_ranks

    device = torch.device(device)
    x = torch.randn(p, 1000, generator=torch.Generator().manual_seed(0))
    # first, so that a missing card raises spawn_ranks' own message
    ranks = spawn_ranks(_selftest_rank, (p,), ("ring",), backend="gloo",
                        device=device, args=(x,))
    want = x.sum(0)
    methods = ("ring", "multi_ring", "tree", "psum", "scatter_gather")
    emulated = {}
    for method in methods:
        emulated[method] = got = allreduce(x.to(device), 0, method).cpu()
        np.testing.assert_allclose(got, want.expand(got.shape), rtol=2e-5,
                                   atol=2e-5)
    print(f"collectives selftest OK p={p} (emulation on {device})")
    for method in methods:
        got = torch.cat([r[method] for r in ranks])
        if not torch.equal(got, emulated[method]):
            raise AssertionError(f"{method}: the process mesh != emulation")
    print(f"collectives selftest OK p={p} (process mesh on {p} ranks, "
          f"backend gloo, {device})")


if __name__ == "__main__":  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser(
        description="every allreduce method, emulated and over p gloo ranks")
    ap.add_argument("p", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    _selftest(args.p, args.device)
