"""Communicator: the paper's MPI-groups-in-KVStore model as an object
(``repro/core/comm.py``).

A ``Communicator`` owns its **group** (a tuple of named device axes; ``()``
is the trivial size-1 group, MPI_COMM_SELF) and its **collective policy**
(bucket algorithm, ring count, byte bucketing, the bf16/int8 wire).
``Communicator.world(axes, sizes)`` builds the top-level group and
``split``/``complement``/``local`` carve sub-groups the way
``MPI_Comm_split`` carves the paper's groups: ``split("data")`` is the
intra-pod gradient group, ``split("pod")`` the cross-pod PS tier. Every
carve inherits the policy.

**Two backends.** The reference runs one program per device under
``shard_map`` on a mesh or nested ``jax.vmap`` on one device; the port
has the same two (``core/collectives.py``):

  emulated  one program runs the whole world on stacked tensors.
            ``frame`` is the world's axes: every per-device value this
            group touches is a tensor whose leading ``len(frame)`` dims
            are the world's device axes, in that order (pod-major), so a
            sub-group's collective runs along its own axes' dims and
            batches over the rest.
  process   one process per device (``mesh=``, a ``launch.mesh.Mesh``):
            each rank holds its own block, the same leading dims at size
            1, and the collectives exchange ``torch.distributed``
            messages inside each axis' process group — the same hops in
            the same order, so the two backends agree bit for bit.

The world of a trivial group has no frame, and its values are plain
per-device tensors.

Multi-axis groups compose collectives hierarchically: a reduce-scatter
over ``("pod", "data")`` reduce-scatters over ``pod`` first, then over
``data`` on the shard — (p−1)/p·n wire bytes in all, the single-axis
geometry. A ``WireMeter`` on the world (``meter=``) counts the bytes
every ring hop puts on the wire; carved groups share it.

The tensor (pytree) collectives pack the whole tree once and run the
same ring programs on the packed buffer; ``emulate_reduce`` runs one over
a stacked member dim, as the in-process PS tier (``core/kvstore``,
``core/algorithms``) holds a group's values.

The schedule-bucketed legs of backward overlap (``reduce_scatter_bucket``,
``allgather_sched``, ``shard_select_sched``) run one single-ring leg per
``flatbuf.BucketSchedule`` bucket.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch

from repro_torch.core import collectives as C, flatbuf
from repro_torch.core.collectives import (  # noqa: F401 (re-exported)
    METHODS,
    RING_METHODS,
    WIRE_DTYPES,
    WireMeter,
    check_wire_dtype,
)
from repro_torch.tree import tree_map

#: the policy knob names, in canonical order
_POLICY_FIELDS = ("method", "num_rings", "bucket_bytes", "wire_dtype",
                  "overlap", "overlap_buckets")


@dataclass(frozen=True)
class CollectivePolicy:
    """One point in the collective-policy space, as a value: allreduce
    method, ring count, byte bucketing, wire protocol and overlap."""

    method: str = "ring"
    num_rings: int = 1
    bucket_bytes: Optional[int] = None
    wire_dtype: Optional[str] = None
    overlap: bool = False
    overlap_buckets: int = 4

    @property
    def wire(self) -> Optional[str]:
        """Normalized wire dtype (None for the full-precision "f32")."""
        return check_wire_dtype(self.wire_dtype, where="CollectivePolicy")

    def replace(self, **kw) -> "CollectivePolicy":
        return replace(self, **kw)

    def validate(self, *, where: str = "CollectivePolicy"
                 ) -> "CollectivePolicy":
        """THE definition of a valid policy point."""
        if self.method not in METHODS:
            raise ValueError(
                f"{where}: allreduce_method (policy.method) must be one "
                f"of {METHODS}, got {self.method!r}")
        wire = check_wire_dtype(self.wire_dtype, where=where)
        if wire is not None and self.method not in RING_METHODS:
            raise ValueError(
                f"{where}: wire_dtype={self.wire_dtype!r} rides the "
                f"explicit ring hops of {RING_METHODS}; "
                f"method={self.method!r} has no wire to quantize")
        if self.num_rings < 1:
            raise ValueError(
                f"{where}: num_rings must be >= 1, got {self.num_rings}")
        if self.bucket_bytes is not None and self.bucket_bytes <= 0:
            raise ValueError(
                f"{where}: bucket_bytes must be positive, "
                f"got {self.bucket_bytes}")
        if self.overlap_buckets < 1:
            raise ValueError(
                f"{where}: overlap_buckets must be >= 1, "
                f"got {self.overlap_buckets}")
        if self.overlap:
            if self.method not in RING_METHODS:
                raise ValueError(
                    f"{where}: overlap schedules per-bucket ring "
                    f"reduce-scatters — method must be one of "
                    f"{RING_METHODS}, got {self.method!r}")
            if self.bucket_bytes is not None:
                raise ValueError(
                    f"{where}: overlap buckets come from the layer-keyed "
                    "schedule — bucket_bytes does not compose with "
                    "overlap (byte-budget bucketing is a ROADMAP item)")
            if self.num_rings != 1:
                raise ValueError(
                    f"{where}: overlap already pipelines the buckets — "
                    f"num_rings must be 1, got {self.num_rings}")
        return self

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in _POLICY_FIELDS}

    @classmethod
    def from_dict(cls, d: dict) -> "CollectivePolicy":
        unknown = set(d) - set(_POLICY_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown CollectivePolicy fields {sorted(unknown)}; "
                f"valid: {_POLICY_FIELDS}")
        return cls(**d)


def _norm_flat(key: str, value):
    if key == "wire_dtype" and value == "f32":
        return None
    if key == "bucket_bytes" and value == 0:
        return None
    return value


def filter_mirrors(flat: dict, *, defaults: dict,
                   prior: Optional[CollectivePolicy]) -> dict:
    """Drop mirror-field values that restate the previous policy (on a
    ``dataclasses.replace`` round trip) or the field defaults (on fresh
    construction): only knobs the caller moved count as input."""
    ref = ({k: getattr(prior, k) for k in flat} if prior is not None
           else defaults)
    return {k: v for k, v in flat.items()
            if _norm_flat(k, v) != _norm_flat(k, ref[k])}


def resolve_policy(policy: Optional[CollectivePolicy], flat: dict, *,
                   base: Optional[CollectivePolicy] = None,
                   where: str = "CollectivePolicy") -> CollectivePolicy:
    """The flat-kwargs deprecation shim: knobs in ``flat`` that change the
    policy (``base`` overridden by ``policy``) apply with one
    ``DeprecationWarning``; knobs restating it pass silently."""
    unknown = set(flat) - set(_POLICY_FIELDS)
    if unknown:
        raise TypeError(
            f"{where}: unknown policy kwargs {sorted(unknown)}; "
            f"valid: {_POLICY_FIELDS} (or policy=CollectivePolicy(...))")
    pol = policy if policy is not None else (
        base if base is not None else CollectivePolicy())
    changed = {k: _norm_flat(k, v) for k, v in flat.items()
               if _norm_flat(k, v) != _norm_flat(k, getattr(pol, k))}
    if not changed:
        return pol
    warnings.warn(
        f"{where}: flat policy kwargs ({', '.join(sorted(changed))}) are "
        "deprecated — pass policy=CollectivePolicy(...) "
        "(one field, one validate()) instead",
        DeprecationWarning, stacklevel=3)
    return replace(pol, **changed)


@dataclass(frozen=True)
class Communicator:
    """One MPI-style group + its collective policy, over a world whose
    axes are ``frame``: emulated in this process, or one process per
    device when ``mesh`` is set (see the module docstring).

    ``axes`` are the named axes the group spans (order = hierarchy order
    for nested collectives: ``axes[0]`` is the outermost level) and
    ``sizes`` their static sizes."""

    axes: tuple[str, ...] = ()
    sizes: tuple[int, ...] = ()
    policy: CollectivePolicy = CollectivePolicy()
    frame: tuple[str, ...] = ()
    meter: Optional[WireMeter] = field(default=None, compare=False)
    mesh: Any = field(default=None, compare=False)

    # -- policy views (read-only) -------------------------------------------
    @property
    def method(self) -> str:
        return self.policy.method

    @property
    def num_rings(self) -> int:
        return self.policy.num_rings

    @property
    def bucket_bytes(self) -> Optional[int]:
        return self.policy.bucket_bytes

    @property
    def wire_dtype(self) -> Optional[str]:
        return self.policy.wire_dtype

    # -- construction -------------------------------------------------------
    @classmethod
    def world(cls, axes=(), sizes=None, *,
              policy: Optional[CollectivePolicy] = None,
              meter: Optional[WireMeter] = None, mesh=None,
              **flat) -> "Communicator":
        """The top-level group over axes of static ``sizes``: emulated,
        or with ``mesh`` (a ``launch.mesh.Mesh``) one process per device,
        the sizes then read from the mesh when omitted. The policy rides
        ``policy=`` (flat knobs shim through ``resolve_policy``)."""
        axes = tuple(axes)
        if mesh is not None:
            unknown = [a for a in axes if a not in mesh.shape]
            if unknown:
                raise ValueError(f"axes {unknown} are not in the mesh's "
                                 f"{dict(mesh.shape)}")
            want = tuple(mesh.shape[a] for a in axes)
            if sizes is not None and tuple(sizes) != want:
                raise ValueError(f"sizes {tuple(sizes)} != the mesh's {want} "
                                 f"for axes {axes}")
            sizes = want
        if axes and sizes is None:
            raise ValueError(
                f"Communicator.world({axes}) needs static sizes: the "
                "emulated world has no mesh to read them from")
        sizes = tuple(int(s) for s in (sizes or ()))
        if len(sizes) != len(axes):
            raise ValueError(f"{len(axes)} axes but {len(sizes)} sizes")
        pol = resolve_policy(policy, flat, where="Communicator.world")
        return cls(axes=axes, sizes=sizes, policy=pol, frame=axes,
                   meter=meter, mesh=mesh)

    def split(self, *axes: str) -> "Communicator":
        """The sub-communicator spanning ``axes`` (``MPI_Comm_split``:
        the implicit color is each device's rank along every other axis).
        Policy, frame and meter are inherited."""
        unknown = [a for a in axes if a not in self.axes]
        if unknown:
            raise ValueError(
                f"cannot split {unknown} out of communicator over "
                f"{self.axes}; valid axes: {self.axes}")
        keep = tuple(a for a in self.axes if a in axes)
        sizes = tuple(s for a, s in zip(self.axes, self.sizes) if a in axes)
        return replace(self, axes=keep, sizes=sizes)

    def complement(self, *axes: str) -> "Communicator":
        """The sub-communicator over every axis NOT named."""
        return self.split(*(a for a in self.axes if a not in axes))

    def local(self) -> "Communicator":
        """The trivial (size-1, MPI_COMM_SELF) group with this policy."""
        return replace(self, axes=(), sizes=())

    def resized(self, size: int, axis: Optional[str] = None) -> "Communicator":
        """The SAME group with one axis re-sized — the re-split an elastic
        membership change performs (``core/membership.py``): a member
        failed, left or joined, so the axis it lived on shrinks or grows
        while the policy is inherited unchanged. Multi-axis groups must
        name which ``axis`` the membership rides."""
        if self.is_trivial:
            raise ValueError("cannot resize the trivial group")
        if size < 1:
            raise ValueError(f"resized group must keep >= 1 member, "
                             f"got {size}")
        if axis is None:
            if len(self.axes) > 1:
                raise ValueError(
                    f"communicator spans {self.axes}; name the membership "
                    "axis: resized(size, axis=...)")
            axis = self.axes[0]
        if axis not in self.axes:
            raise ValueError(f"no axis {axis!r} in {self.axes}")
        sizes = tuple(int(size) if a == axis else s
                      for a, s in zip(self.axes, self.sizes))
        return replace(self, sizes=sizes)

    def with_policy(self, policy: Optional[CollectivePolicy] = None,
                    **kw) -> "Communicator":
        """Same group, new policy: a whole ``CollectivePolicy`` or field
        overrides."""
        if policy is not None:
            if kw:
                raise TypeError(
                    "with_policy: pass policy= or field overrides, not both")
            return replace(self, policy=policy)
        return replace(self, policy=self.policy.replace(**kw))

    # -- geometry -----------------------------------------------------------
    @property
    def is_trivial(self) -> bool:
        return not self.axes

    @property
    def backend(self) -> str:
        """"trivial" (the size-1 short circuit), "named_axis" (the
        reference's name: here the stacked emulated axes of ``frame``) or
        "process" (one process per device over ``mesh``)."""
        if self.is_trivial:
            return "trivial"
        return "named_axis" if self.mesh is None else "process"

    @property
    def static_size(self) -> int:
        return math.prod(self.sizes)

    def resolve_size(self) -> int:
        return self.static_size

    @property
    def wire(self) -> Optional[str]:
        """Normalized wire dtype (None for the full-precision "f32")."""
        return check_wire_dtype(self.policy.wire_dtype, where="Communicator")

    def _require_plain_wire(self, what: str) -> None:
        if self.wire is not None:
            raise ValueError(
                f"wire_dtype={self.policy.wire_dtype!r} only rides the "
                f"explicit ring hops (methods {RING_METHODS}), but this "
                f"group dispatches {what}")

    def rings_for(self, nbytes: int) -> int:
        """The policy's effective ring count for an ``nbytes`` buffer."""
        return flatbuf.effective_rings(nbytes, self.policy.num_rings,
                                       self.policy.bucket_bytes)

    def shard_geometry(self, n: int, num_rings: Optional[int] = None,
                       *, itemsize: int = 4) -> tuple[int, int]:
        """(per-device shard length, padded total) for a length-``n``
        buffer sharded over the whole group under the full ring policy."""
        p = self.resolve_size()
        nr = self.rings_for(n * itemsize) if num_rings is None else num_rings
        _, total = flatbuf.shard_geometry(n, p, nr)
        return total // p, total

    def _dim(self, axis: str):
        """The collectives' handle on ``axis``: its stacked dim (emulated)
        or this rank's ``collectives.RankAxis`` (process)."""
        d = self.frame.index(axis)
        return d if self.mesh is None else self.mesh.rank_axis(axis, d)

    def _members(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
        """``x`` with the group's axes' dims holding every member (under
        the process backend, one all-gather over the flattened group) and
        those dims: what ``psum`` / ``pmean`` reduce."""
        dims = tuple(self.frame.index(a) for a in self.axes)
        if self.mesh is None:
            return x, dims
        axes = [self._dim(a) for a in self.axes]
        return (C.gather_members(x, axes, self.mesh.get_group(self.axes),
                                 self.mesh.link), dims)

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        """A stacked per-device value as ``(*world, payload)``."""
        return x.reshape(tuple(x.shape[:len(self.frame)]) + (-1,))

    def _nbytes(self, x: torch.Tensor) -> int:
        """One device's bytes of the stacked value ``x``."""
        return math.prod(x.shape[len(self.frame):]) * x.element_size()

    # -- collectives over stacked per-device values --------------------------
    def allreduce(self, x: torch.Tensor, *, mean: bool = False) -> torch.Tensor:
        """Policy-dispatched allreduce (sum) over the whole group.
        Multi-axis ring-family groups and every quantized wire run the
        hierarchical reduce-scatter + allgather composition; ``tree``
        reduces one axis at a time."""
        out = x
        if not self.axes:
            pass
        elif self.policy.method == "psum":
            self._require_plain_wire("a native psum")
            full, dims = self._members(x)
            out = full.sum(dims, keepdim=True).expand(x.shape).clone()
        elif self.policy.method == "tree" or (
                len(self.axes) == 1 and self.wire is None):
            if self.policy.method == "tree":
                self._require_plain_wire("full-buffer binomial-tree hops")
            nr = self.rings_for(self._nbytes(x))
            flat = self._flat(x)
            for a in self.axes:
                flat = C.allreduce(flat, self._dim(a), self.policy.method,
                                   num_rings=nr, meter=self.meter)
            out = flat.reshape(x.shape)
        else:
            if self.policy.method == "per_leaf":
                self._require_plain_wire("the per-leaf baseline")
            flat = self._flat(x)
            n = flat.shape[-1]
            nr = self.rings_for(self._nbytes(x))
            _, total = flatbuf.shard_geometry(n, self.resolve_size(), nr)
            shard = self.reduce_scatter(C._pad_to(flat, total), num_rings=nr)
            full = self.allgather(shard, num_rings=nr)[..., :n]
            out = full.reshape(x.shape).to(x.dtype)
        if mean:
            out = out / self.resolve_size()
        return out

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the group (metrics leg), replicated to every member:
        cheap scalar traffic, not part of any byte-accounted leg."""
        if self.is_trivial:
            return x
        full, dims = self._members(x)
        return full.mean(dims, keepdim=True).expand(x.shape)

    def reduce_scatter(self, buf: torch.Tensor, *,
                       num_rings: Optional[int] = None) -> torch.Tensor:
        """Hierarchical ring reduce-scatter of a stacked flat buffer:
        level k reduce-scatters level k-1's shard over ``axes[k]``. The
        final shard is 1/(prod sizes) of the padded buffer; the default
        ring count resolves from the whole buffer's bytes."""
        out = self._flat(buf)
        nr = self.rings_for(self._nbytes(out)) if num_rings is None else num_rings
        for a in self.axes:
            out = C.ring_reduce_scatter(out, self._dim(a), num_rings=nr,
                                        wire_dtype=self.wire, meter=self.meter)
        return out

    def allgather(self, shard: torch.Tensor, *,
                  num_rings: Optional[int] = None) -> torch.Tensor:
        """Inverse of ``reduce_scatter``: gather level by level, innermost
        axis first. The default ring count resolves from the gathered
        buffer's bytes."""
        out = self._flat(shard)
        nr = (self.rings_for(self._nbytes(out) * self.resolve_size())
              if num_rings is None else num_rings)
        for a in reversed(self.axes):
            out = C.ring_allgather(out, self._dim(a), num_rings=nr,
                                   wire_dtype=self.wire, meter=self.meter)
        return out

    def shard_select(self, buf: torch.Tensor, *,
                     num_rings: Optional[int] = None) -> torch.Tensor:
        """Each device's shard of a *replicated* stacked flat buffer —
        the slice ``reduce_scatter`` with the same geometry leaves there."""
        out = self._flat(buf)
        nr = self.rings_for(self._nbytes(out)) if num_rings is None else num_rings
        for a in self.axes:
            out = C.shard_select(out, self._dim(a), num_rings=nr)
        return out

    # -- schedule-bucketed legs (backward overlap) ----------------------------
    def reduce_scatter_bucket(self, seg: torch.Tensor, schedule,
                              b: int) -> torch.Tensor:
        """One schedule bucket's reduce-scatter leg over the whole group,
        nested per axis (pod first, then data on the shard — the same
        hierarchy as ``reduce_scatter``, at the telescoped (p-1)/p·size_b
        wire bytes). Single-ring per bucket: the schedule buckets ARE the
        overlap units. Returns each device's ``(…, chunks[b])`` chunk."""
        out = C._pad_to(self._flat(seg), schedule.bucket_padded(b))
        for a in self.axes:
            out = C.ring_reduce_scatter(out, self._dim(a), num_rings=1,
                                        wire_dtype=self.wire, meter=self.meter)
        return out

    def allgather_sched(self, shard: torch.Tensor, schedule) -> torch.Tensor:
        """The ONE trailing allgather of the overlapped step: gather each
        device's whole schedule shard (bucket-major concat of chunks,
        ``schedule.shard_size`` long) level by level, innermost axis
        first, then re-stitch the device-major result into the
        ``(…, spec.size)`` packed layout."""
        out = self._flat(shard)
        for a in reversed(self.axes):
            out = C.ring_allgather(out, self._dim(a), num_rings=1,
                                   wire_dtype=self.wire, meter=self.meter)
        return C.sched_reassemble(out, schedule)

    def shard_select_sched(self, buf: torch.Tensor, schedule) -> torch.Tensor:
        """Each device's schedule shard of a *replicated* packed buffer —
        per bucket exactly the chunk ``reduce_scatter_bucket`` leaves
        there, concatenated bucket-major to pair with the reduced grads.
        Static slices and per-axis selection, no communication."""
        flat = self._flat(buf)
        parts = []
        for b in range(schedule.num_buckets):
            s, n = schedule.starts[b], schedule.sizes[b]
            seg = C._pad_to(flat[..., s:s + n], schedule.bucket_padded(b))
            for a in self.axes:
                seg = C.shard_select(seg, self._dim(a), num_rings=1)
            parts.append(seg)
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

    # -- tensor (fused-pytree) collectives ------------------------------------
    def _member_spec(self, tree) -> flatbuf.FlatBuffer:
        """The FlatBuffer of ONE device's tree (the frame dims stripped)."""
        k = len(self.frame)
        return flatbuf.spec_for(tree_map(lambda l: l[(0,) * k], tree))

    def tensor_allreduce(self, tree, *, mean: bool = False,
                         spec: Optional[flatbuf.FlatBuffer] = None):
        """Allreduce a whole stacked pytree as ONE fused flat buffer (the
        paper's group-of-vectors object), under this group's policy;
        ``per_leaf`` is the one-vector-at-a-time baseline."""
        if self.policy.method == "per_leaf":
            self._require_plain_wire("the per-leaf baseline")
            out = tree
            for a in self.axes:
                out = tree_map(
                    lambda l, a=a: C.allreduce(
                        self._flat(l.float()), self._dim(a), "ring",
                        meter=self.meter).reshape(l.shape).to(l.dtype), out)
            if mean:
                p = self.resolve_size()
                out = tree_map(lambda l: l / p, out)
            return out
        spec = spec or self._member_spec(tree)
        return spec.unpack(self.allreduce(spec.pack(tree), mean=mean))

    def pushpull(self, tree, *, fused: bool = True,
                 spec: Optional[flatbuf.FlatBuffer] = None):
        """The KVStore.pushpull pattern inside this group (§4.2.4 with
        #servers = 0): ``fused=True`` is one tensor allreduce (mean) under
        the group's bucket algorithm; ``fused=False`` is push then pull —
        a binomial tree reduce + broadcast of the packed buffer."""
        if fused:
            return self.tensor_allreduce(tree, mean=True, spec=spec)
        self._require_plain_wire("the tree push + tree pull pattern")
        spec = spec or self._member_spec(tree)
        buf = spec.pack(tree)
        for a in self.axes:
            buf = C.tree_allreduce(buf, self._dim(a))
        return spec.unpack(buf / self.resolve_size())

    def emulate_reduce(self, stacked, *, mean: bool = False):
        """The group collective over a *stacked* member value: one leading
        dim per axis of the group, of the axis' static size — how the
        in-process PS tier holds a group's values. The group's own axes
        become the (emulated) frame; the pytree is packed once."""
        if self.is_trivial:
            return stacked
        return replace(self, frame=self.axes, mesh=None).tensor_allreduce(
            stacked, mean=mean)


#: module-level trivial group (MPI_COMM_SELF with the default policy)
LOCAL = Communicator()


def from_sync(sync, axes=(), sizes=None, *,
              meter: Optional[WireMeter] = None, mesh=None) -> Communicator:
    """Build a communicator from a ``SyncConfig`` recipe: its resolved
    ``CollectivePolicy`` becomes the group's policy verbatim."""
    return Communicator.world(axes, sizes, policy=sync.policy, meter=meter,
                              mesh=mesh)


def sync_comms(sync, world: Communicator
               ) -> tuple[Communicator, Optional[Communicator]]:
    """A SyncConfig's (gradient group, exchange group) over a world — the
    paper's mode table as group algebra:

      mpi_sgd   one communicator spanning every axis (C = 1 pure-MPI
                mode); no exchange
      mpi_esgd  the 'pod' axis is the PS tier: the gradient group is
                everything BUT 'pod', the exchange group IS 'pod'. A world
                without a 'pod' axis maps device == client: the whole
                world is the exchange group, the gradient group trivial.
    """
    if sync.mode == "mpi_sgd":
        return world, None
    if sync.mode != "mpi_esgd":
        raise ValueError(f"lowerable modes are mpi_sgd/mpi_esgd, "
                         f"got {sync.mode!r}")
    if "pod" in world.axes:
        return world.complement("pod"), world.split("pod")
    return world.local(), world
