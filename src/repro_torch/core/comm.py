"""Communicator: the paper's MPI-groups-in-KVStore model as an object.

Slice 1 carries the trivial group only: ``LOCAL`` (MPI_COMM_SELF, size 1),
whose collectives are the identity, plus the one ``CollectivePolicy``
value every config layer carries (``repro/core/comm.py``). A group of
size > 1 raises: its ring collectives arrive with slice 2, and returning
an unreduced buffer in their place would be silently wrong.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core import flatbuf

#: the collective methods and wire dtypes of the reference
#: (``repro/core/collectives.py``)
METHODS = ("ring", "multi_ring", "tree", "psum", "per_leaf", "scatter_gather")
WIRE_DTYPES = (None, "f32", "bf16", "int8")
RING_METHODS = ("ring", "multi_ring", "scatter_gather")

#: the policy knob names, in canonical order
_POLICY_FIELDS = ("method", "num_rings", "bucket_bytes", "wire_dtype",
                  "overlap", "overlap_buckets")


def check_wire_dtype(wire_dtype, *, where: str) -> "str | None":
    """Validate + normalize a wire dtype ("f32" -> None)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"{where}: wire_dtype must be one of {WIRE_DTYPES}, "
            f"got {wire_dtype!r}")
    return None if wire_dtype == "f32" else wire_dtype


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
                    "overlap")
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
    """One MPI-style group + its collective policy. Slice 1: the trivial
    group only (``axes == ()``)."""

    axes: tuple[str, ...] = ()
    sizes: Optional[tuple[int, ...]] = ()
    policy: CollectivePolicy = CollectivePolicy()

    def __post_init__(self) -> None:
        if self.axes:
            raise NotImplementedError(
                f"slice 2: a communicator over axes {self.axes} needs the "
                "ring collectives, which are not ported yet")

    @classmethod
    def world(cls, axes=(), sizes=None, *,
              policy: Optional[CollectivePolicy] = None) -> "Communicator":
        """The top-level group; only the trivial (no-axis) world exists
        in this slice."""
        return cls(axes=tuple(axes), sizes=(), policy=policy or CollectivePolicy())

    def resolve_size(self) -> int:
        return 1

    def local(self) -> "Communicator":
        """The trivial (size-1, MPI_COMM_SELF) group with this policy."""
        return replace(self, axes=(), sizes=())

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

    def rings_for(self, nbytes: int) -> int:
        """The policy's effective ring count for an ``nbytes`` buffer."""
        return flatbuf.effective_rings(nbytes, self.policy.num_rings,
                                       self.policy.bucket_bytes)


#: module-level trivial group (MPI_COMM_SELF with the default policy)
LOCAL = Communicator()


def from_sync(sync, axes=()) -> Communicator:
    """Build the gradient group from a ``SyncConfig`` recipe: its resolved
    ``CollectivePolicy`` becomes the group's policy verbatim."""
    return Communicator.world(axes, policy=sync.policy)
