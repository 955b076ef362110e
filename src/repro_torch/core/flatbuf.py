"""Persistent flat-buffer substrate for fused ("tensor") collectives.

The paper's core object is the *group of vectors treated as one*: the whole
gradient pytree rides a single bucket algorithm. A ``FlatBuffer`` is the
static packing spec of one pytree, computed ONCE per model: per-leaf
offsets, shapes and dtypes, every leaf padded to a lane-aligned start.
``pack`` and ``unpack`` are static-slice copies.

The layout is the reference's exactly (``repro/core/flatbuf.py``): leaves
in sorted-key order (``repro_torch.tree``), offsets aligned to ``LANE``,
the total a multiple of ``LANE * SUBLANE``. The buffer is f32 whatever the
param dtype: ``pack`` widens and ``unpack`` rounds back.

``BucketSchedule`` partitions a packed buffer at leaf boundaries into the
backward-overlap schedule buckets, one per backward stage.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels.common import LANE, SUBLANE
from repro_torch.kernels.quant_bucket.quant_bucket import WIRE_BLOCK
from repro_torch.tree import TreeDef, tree_flatten, tree_leaves, tree_unflatten


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


@dataclass(frozen=True)
class FlatBuffer:
    """Static packing spec for one pytree: the fused tensor object."""

    treedef: TreeDef
    shapes: tuple
    dtypes: tuple
    sizes: tuple      # true element count per leaf
    offsets: tuple    # lane-aligned start of each leaf in the buffer
    size: int         # padded total length (multiple of LANE*SUBLANE)
    dtype: torch.dtype = torch.float32

    @property
    def num_leaves(self) -> int:
        return len(self.sizes)

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    @property
    def payload(self) -> int:
        """True (unpadded) element count across leaves."""
        return sum(self.sizes)

    def _leaves(self, tree: Any) -> list:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError(f"tree structure {treedef} does not match the "
                             f"spec's {self.treedef}")
        return leaves

    def _lead(self, leaves: list) -> tuple:
        """The leading (stacked device/client) dims the leaves carry ahead
        of the spec's shapes — ``()`` for one unstacked tree."""
        lead = None
        for leaf, shape in zip(leaves, self.shapes):
            k = leaf.dim() - len(shape)
            if k < 0 or tuple(leaf.shape[k:]) != shape:
                raise ValueError(f"leaf shape {tuple(leaf.shape)} does not "
                                 f"end in the spec's {shape}")
            if lead is None:
                lead = tuple(leaf.shape[:k])
            elif tuple(leaf.shape[:k]) != lead:
                raise ValueError(f"leaves stacked over {lead} and "
                                 f"{tuple(leaf.shape[:k])}")
        return lead or ()

    def pack(self, tree: Any, total: int | None = None) -> torch.Tensor:
        """Pytree -> one ``(size,)`` buffer (zero-extended to ``total``
        when that is longer). Static slices only. A tree whose leaves all
        carry the same leading dims (stacked devices or clients) packs to
        ``(*lead, size)``, one row per member."""
        leaves = self._leaves(tree)
        lead = self._lead(leaves)
        buf = torch.zeros(lead + (max(total or 0, self.size),),
                          dtype=self.dtype, device=leaves[0].device)
        for off, n, leaf in zip(self.offsets, self.sizes, leaves):
            buf[..., off:off + n].copy_(leaf.reshape(lead + (n,)))
        return buf

    def unpack(self, buf: torch.Tensor) -> Any:
        """Inverse of ``pack``: restore leaf shapes and dtypes (a stacked
        ``(*lead, m)`` buffer unpacks to leaves stacked over ``lead``)."""
        lead = tuple(buf.shape[:-1])
        leaves = [
            buf[..., off:off + n].reshape(lead + shape).to(dt)
            for off, n, shape, dt in zip(
                self.offsets, self.sizes, self.shapes, self.dtypes)
        ]
        return tree_unflatten(self.treedef, leaves)

    def leaf_view(self, buf: torch.Tensor, index: int) -> torch.Tensor:
        """Leaf ``index`` of a packed buffer, reshaped (buffer dtype: a
        view, no copy)."""
        off, n = self.offsets[index], self.sizes[index]
        return buf[off:off + n].view(self.shapes[index])

    def zeros(self, device=None) -> torch.Tensor:
        return torch.zeros((self.size,), dtype=self.dtype, device=device)


def make_flatbuf(tree: Any, dtype: torch.dtype = torch.float32, *,
                 align: int = LANE) -> FlatBuffer:
    """Build the spec from a pytree of tensors (``meta`` tensors do: only
    shapes and dtypes are read)."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    dtypes = tuple(leaf.dtype for leaf in leaves)
    sizes = tuple(math.prod(s) if s else 1 for s in shapes)
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += _align(max(n, 1), align)
    total = _align(max(off, align), LANE * SUBLANE)
    return FlatBuffer(treedef, shapes, dtypes, sizes, tuple(offsets), total,
                      dtype)


def spec_for(tree: Any, dtype: torch.dtype = torch.float32) -> FlatBuffer:
    """The spec of ``tree``. The reference memoizes it for its eager
    drivers; here the sync engine builds it once per model and keeps it."""
    return make_flatbuf(tree, dtype)


# --------------------------------------------------------------------------
# Shard geometry: how a flat buffer splits across p devices × R rings
# --------------------------------------------------------------------------

def edge_grid() -> int:
    """The grid every schedule-bucket edge sits on: the least common
    multiple of LANE and the int8 wire codec's WIRE_BLOCK."""
    return LANE * WIRE_BLOCK // math.gcd(LANE, WIRE_BLOCK)


def align_edge(n: int, *, align: int | None = None) -> int:
    """Round a schedule-bucket edge (or shard chunk) up to the LANE ×
    WIRE_BLOCK grid (or to ``align``)."""
    a = align if align is not None else edge_grid()
    if n < 0:
        raise ValueError(f"bucket edge must be >= 0, got {n}")
    return _align(n, a)


def shard_geometry(n: int, p: int, num_rings: int = 1,
                   *, align: int = LANE) -> tuple[int, int]:
    """(per-ring chunk, padded total) for a length-``n`` buffer split over
    ``p`` devices × ``num_rings`` ring schedules; the chunk is
    lane-aligned."""
    r = max(num_rings, 1)
    chunk = align_edge(-(-n // (p * r * align)) * align if n else align,
                       align=align)
    chunk = max(chunk, align)
    return chunk, p * r * chunk


def effective_rings(nbytes: int, num_rings: int = 1,
                    bucket_bytes: int | None = None, *,
                    max_rings: int = 32) -> int:
    """Compose the explicit ring count with byte-sized bucketing
    (ceil(nbytes/bucket_bytes) schedules); the larger wins, capped at
    ``max_rings``."""
    r = max(num_rings, 1)
    if bucket_bytes:
        r = max(r, -(-int(nbytes) // int(bucket_bytes)))
    return min(r, max_rings)


def pack_padded(spec: FlatBuffer, tree: Any, total: int) -> torch.Tensor:
    """``spec.pack`` zero-extended to a ring geometry's ``total`` length."""
    return spec.pack(tree, total)


def shard_size(spec: FlatBuffer, p: int = 1, num_rings: int = 1,
               bucket_bytes: int | None = None) -> int:
    """Per-device shard length (= optimizer-state length) for a spec."""
    r = effective_rings(spec.nbytes, num_rings, bucket_bytes)
    _, total = shard_geometry(spec.size, p, r)
    return total // p


# --------------------------------------------------------------------------
# Schedule buckets: the backward-overlap partition of a packed buffer
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BucketSchedule:
    """Leaf-boundary-keyed partition of a packed buffer into schedule
    buckets, one per backward stage (``repro/core/flatbuf.py``).

    Bucket ``b`` spans ``[starts[b], starts[b] + sizes[b])`` of the packed
    buffer and owns leaves ``[leaf_starts[b], leaf_starts[b+1])`` of the
    spec. Every edge sits on the LANE × WIRE_BLOCK grid, so per-bucket
    int8 wire scales never straddle a bucket. The buckets tile the spec
    exactly: ``starts[0] == 0`` and ``sum(sizes) == spec.size``.

    ``chunks[b]`` is the per-device ring chunk of bucket ``b``'s
    single-ring reduce-scatter leg at ``p`` total shards. A device's shard
    of the whole schedule is the concatenation of its per-bucket chunks:
    length ``shard_size = sum(chunks)``, bucket ``b``'s chunk at
    ``shard_offsets[b]``.
    """

    spec: FlatBuffer
    starts: tuple      # bucket start offsets in the packed buffer
    sizes: tuple       # bucket extents; sum == spec.size
    leaf_starts: tuple  # first spec-leaf index of each bucket, + sentinel
    p: int             # total shard count the per-bucket legs run at
    chunks: tuple      # per-device chunk of each bucket's ring leg

    @property
    def num_buckets(self) -> int:
        return len(self.sizes)

    @property
    def shard_size(self) -> int:
        """Per-device shard length (= overlapped optimizer-state length)."""
        return sum(self.chunks)

    @property
    def shard_offsets(self) -> tuple:
        offs, off = [], 0
        for c in self.chunks:
            offs.append(off)
            off += c
        return tuple(offs)

    def bucket_padded(self, b: int) -> int:
        """Padded length of bucket ``b``'s ring leg (p × chunk)."""
        return self.p * self.chunks[b]

    def pack_bucket(self, b: int, tree_b: Any) -> torch.Tensor:
        """Pack bucket ``b``'s leaves (a stage's grad subtree, in spec
        leaf order) into its ``(sizes[b],)`` segment of the buffer."""
        leaves = tree_leaves(tree_b)
        lo, hi = self.leaf_starts[b], self.leaf_starts[b + 1]
        if len(leaves) != hi - lo:
            raise ValueError(
                f"bucket {b} owns {hi - lo} leaves but the stage tree has "
                f"{len(leaves)} — the stage partition and the schedule "
                f"must come from the same overlap_stages split")
        buf = torch.zeros((self.sizes[b],), dtype=self.spec.dtype,
                          device=leaves[0].device)
        base = self.starts[b]
        for i, leaf in zip(range(lo, hi), leaves):
            off = self.spec.offsets[i] - base
            buf[off:off + self.spec.sizes[i]].copy_(leaf.reshape(-1))
        return buf

    def with_p(self, p: int) -> "BucketSchedule":
        """The same stage partition re-laid-out for ``p`` shards (e.g. the
        local p=1 state geometry vs a device-sharded driver's p)."""
        if p == self.p:
            return self
        counts = tuple(self.leaf_starts[b + 1] - self.leaf_starts[b]
                       for b in range(self.num_buckets))
        return bucket_schedule(self.spec, counts, p)


def bucket_schedule(spec: FlatBuffer, leaf_counts, p: int) -> BucketSchedule:
    """Build the backward-overlap schedule for ``spec`` split at leaf
    boundaries: ``leaf_counts[b]`` spec leaves go to bucket ``b`` (stage
    order — the packing order of the spec). ``p`` is the total shard
    count the per-bucket reduce-scatter legs will run at."""
    counts = tuple(int(c) for c in leaf_counts)
    if any(c <= 0 for c in counts):
        raise ValueError(
            f"every schedule bucket needs at least one leaf, got "
            f"leaf_counts={counts} — merge empty stages before building "
            f"the schedule (lower overlap_buckets)")
    if sum(counts) != spec.num_leaves:
        raise ValueError(
            f"leaf_counts {counts} sum to {sum(counts)} but the spec has "
            f"{spec.num_leaves} leaves — the schedule must tile the "
            f"packed buffer exactly")
    leaf_starts, li = [], 0
    for c in counts:
        leaf_starts.append(li)
        li += c
    leaf_starts.append(li)
    starts = [spec.offsets[leaf_starts[b]] for b in range(len(counts))]
    ends = starts[1:] + [spec.size]
    sizes = [e - s for s, e in zip(starts, ends)]
    grid = edge_grid()
    for b, (s, n) in enumerate(zip(starts, sizes)):
        if s % grid or (s + n) % grid:
            raise ValueError(
                f"bucket {b} edge [{s}, {s + n}) is off the LANE×"
                f"WIRE_BLOCK grid ({grid}) — pack with make_flatbuf's "
                f"default LANE alignment so leaf boundaries are valid "
                f"bucket edges")
        if n < WIRE_BLOCK:
            raise ValueError(
                f"bucket {b} spans {n} elements < one WIRE_BLOCK "
                f"({WIRE_BLOCK}) — an int8 wire scale group would "
                f"straddle buckets; merge stages (lower overlap_buckets) "
                f"until every bucket holds at least one wire block")
    chunks = tuple(shard_geometry(n, p, 1)[0] for n in sizes)
    return BucketSchedule(spec, tuple(starts), tuple(sizes),
                          tuple(leaf_starts), int(p), chunks)
