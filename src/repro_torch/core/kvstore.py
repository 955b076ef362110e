"""KVStore-MPI (paper §3.2/§4.2; ``repro/core/kvstore.py``): the distributed
<key, value> store with ``create / init / set_optimizer / push / pull /
pushpull``.

The store simulates the PS tier in one process (values sharded over
``num_servers`` for cost accounting); workers address it through the API
the paper's workers use:

- ``push(key, tensor)``: a whole pytree, or a list of them (the paper's
  group-of-vectors, one per local device). The store applies the server
  rule:
    * sync types buffer pushes until all expected pushers arrive (barrier)
    * async types apply each push immediately (staleness!)
- ``pull(key)`` returns the current server value, once per destination
  slot.
- ``pushpull`` fuses both (the API the paper added, §4.2.4).

MPI types ("sync_mpi"/"async_mpi") only change WHO pushes: the client
master, after an intra-client tensor allreduce. That collective is a
first-class *group* here (the paper's MPI-communicators-in-KVStore
model): ``register_group`` attaches a ``core.comm.Communicator`` per
client group, and ``push(..., group=)`` runs the group collective over
the stacked member values before the PS tier.

Pushed pytrees are ONE fused object end to end: the sync barrier sums the
pushes as packed ``FlatBuffer``s in arrival order and unpacks once; the
elastic rule (``set_elastic``) runs eq. (2) as one packed buffer through
the fused server kernel (``flat_exchange=True``, the default); an int8
push into that rule is one packed buffer through the streaming wire
codec.

A list push of several device values (the paper's group-of-vectors, one
value per local device) is reduced on the worker first, leaf by leaf,
through the grouped-vector reduction kernel (``local_reduce``). An int8
push outside the flat elastic rule takes the per-leaf QBLOCK codec
(``kernels.quant_bucket.ops``). An attached ``Membership`` degrades the
sync barrier to the live-member count.

Every rule stores new tensors and writes into none it was given: the
runners hand the same tree to several clients and to the store.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core import flatbuf
from repro_torch.core.collectives import check_wire_dtype
from repro_torch.core.comm import Communicator
from repro_torch.core.elastic import (
    elastic_server_packed,
    elastic_server_update,
    scale_packed,
    wire_packed,
)
from repro_torch.kernels.quant_bucket.ops import (
    compress,
    compressed_bytes,
    decompress,
)
from repro_torch.kernels.quant_bucket.quant_bucket import wire_nbytes
from repro_torch.kernels.tensor_reduce.ops import group_reduce
from repro_torch.optim.sgd import Optimizer
from repro_torch.tree import tree_leaves, tree_map

VALID_TYPES = ("local", "dist_sync", "dist_async", "sync_mpi", "async_mpi")


def _nbytes(tree: Any) -> int:
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


def _all_float(tree: Any) -> bool:
    return all(l.is_floating_point() for l in tree_leaves(tree))


def local_reduce(tensor: list) -> Any:
    """Reduce the group-of-vectors on a worker (one value per local
    device; values may be whole pytrees): each leaf's values are stacked
    and summed by the grouped-vector reduction kernel (``group_reduce``),
    f32-accumulated in member order."""
    if len(tensor) == 1:
        return tensor[0]
    return tree_map(lambda *xs: group_reduce(torch.stack(xs)), *tensor)


@dataclass
class _ServerRule:
    """What the server does with an aggregated push (set via set_optimizer)."""

    kind: str = "assign"  # assign | optimize | elastic
    optimizer: Optional[Optimizer] = None
    rescale: float = 1.0
    alpha: float = 0.0  # elastic


class KVStore:
    """In-process PS tier + the worker-facing API."""

    def __init__(self, kv_type: str, *, num_workers: int = 1,
                 num_servers: int = 1, num_clients: Optional[int] = None,
                 compress_push: bool = False,
                 wire_dtype: Optional[str] = None,
                 flat_exchange: bool = True,
                 barrier_timeout: Optional[float] = None):
        if kv_type not in VALID_TYPES:
            raise ValueError(f"kv_type must be one of {VALID_TYPES}")
        if compress_push:
            raise ValueError(
                "KVStore(compress_push=True) was removed — it is the "
                "int8 wire: pass wire_dtype='int8' instead")
        self.kv_type = kv_type
        self.num_workers = num_workers
        self.num_servers = max(num_servers, 1)
        self.num_clients = num_clients or num_workers
        # low-precision PS wire: "int8" block-quantizes the packed push,
        # "bf16" casts it
        self.wire_dtype = check_wire_dtype(wire_dtype, where="KVStore")
        # elastic rule as ONE packed buffer + ONE fused kernel; False =
        # the per-leaf reference
        self.flat_exchange = flat_exchange
        self.pushed_bytes = 0
        self.pushed_bytes_uncompressed = 0
        self.is_mpi = kv_type.endswith("_mpi")
        self.is_sync = kv_type in ("dist_sync", "sync_mpi")
        # pushers the sync barrier waits for
        self._static_expected = (self.num_clients if self.is_mpi
                                 else num_workers)
        # failure tolerance (paper §2-3): ``barrier_timeout`` simulated
        # seconds past a round's first arrival, the sync barrier releases
        # with the pushes that made it (pull(now=...) drives the clock)
        self.barrier_timeout = barrier_timeout
        self._membership = None
        self._staleness = None
        self._stale_scale = False
        self.degraded_syncs = 0          # barriers released short
        self.late_pushes = 0             # pushes landing after release
        self.last_barrier_count: Optional[int] = None
        self._first_arrival: dict[Any, float] = {}
        self._values: dict[Any, Any] = {}
        self._opt_state: dict[Any, Any] = {}
        self._pending: dict[Any, list] = {}
        self._rule = _ServerRule()
        self.push_count: dict[Any, int] = {}
        # MPI groups embedded in the store (paper §3-4): group id -> the
        # intra-group communicator; + per-group collective counters
        self._groups: dict[Any, Communicator] = {}
        self.group_sync_count: dict[Any, int] = {}

    @property
    def expected_pushers(self) -> int:
        """Pushers the sync barrier waits for: the static client/worker
        count, degraded to the live-member count when a ``Membership`` is
        attached — an announced leave or failure shrinks the barrier at
        once; unannounced deaths degrade it through barrier_timeout."""
        base = self._static_expected
        if self._membership is not None:
            return max(1, min(base, self._membership.live_count))
        return base

    def attach_membership(self, membership) -> None:
        """Attach the tier's ``core.membership.Membership``: the barrier
        tracks its live count from now on."""
        self._membership = membership

    def attach_staleness(self, tracker, *, scale: bool = False) -> None:
        """Wire a ``scheduler.StalenessTracker`` into the server rule:
        ``push(..., unit=)`` records the apply (and its staleness),
        ``pull(..., unit=)`` the pull. With ``scale=True`` the optimize
        rule damps a push that is s versions stale by 1/(1+s), as one
        packed multiply (``core.elastic.scale_packed``)."""
        self._staleness = tracker
        self._stale_scale = scale

    def _require_key(self, key: Any, what: str) -> None:
        if key not in self._values:
            known = ", ".join(repr(k) for k in self._values) or "(none)"
            raise KeyError(
                f"{what} of unregistered key {key!r} — known keys: "
                f"{known}; register it first with kv.init({key!r}, value)")

    # -- setup --------------------------------------------------------------
    @classmethod
    def create(cls, kv_type: str, **kw) -> "KVStore":
        return cls(kv_type, **kw)

    def init(self, key: Any, value: Any) -> None:
        """Rank 0 initializes keys on the servers (paper §4.2.1)."""
        if key in self._values:
            raise KeyError(f"key {key!r} already initialized")
        self._values[key] = value
        self.push_count[key] = 0
        if self._rule.kind == "optimize":
            self._opt_state[key] = self._rule.optimizer.init(value)

    def set_optimizer(self, optimizer: Optimizer, *, rescale: float = 1.0) -> None:
        """Ship the update rule to the server (remote config, §3.2)."""
        self._rule = _ServerRule("optimize", optimizer, rescale)
        for key, value in self._values.items():
            self._opt_state[key] = optimizer.init(value)

    def set_elastic(self, alpha: float) -> None:
        """Server-side Elastic1 (eq. 2): values become center variables."""
        self._rule = _ServerRule("elastic", alpha=alpha)

    def register_group(self, gid: Any, group: Communicator) -> None:
        """Attach an MPI group (a ``core.comm.Communicator``) to the store —
        the paper's communicator-in-KVStore embedding. Pushes tagged
        ``group=gid`` run the group's collective first; the PS rule then
        spans groups."""
        if not isinstance(group, Communicator):
            raise TypeError(
                f"register_group wants a core.comm.Communicator, got "
                f"{type(group).__name__} — build one with "
                "Communicator.world(axes, sizes)")
        self._groups[gid] = group
        self.group_sync_count.setdefault(gid, 0)

    def group(self, gid: Any) -> Communicator:
        return self._groups[gid]

    def group_reduce(self, gid: Any, stacked: Any, *,
                     mean: bool = False) -> Any:
        """The intra-group collective: ``stacked`` carries a leading member
        dim (= group size); the registered communicator's tensor allreduce
        runs over it and the group master's copy is returned — the sum by
        default, the client-sum a master pushes. A multi-axis group has
        the member dim reshaped to its axis sizes first."""
        group = self._groups[gid]
        leaves = tree_leaves(stacked)
        members = leaves[0].shape[0] if leaves else 1
        want = group.static_size
        if members != want:
            raise ValueError(
                f"group {gid!r} push carries {members} stacked members "
                f"but the registered communicator spans {want} ranks "
                f"(axes {group.axes}, sizes {group.sizes}) — stack one "
                "entry per group member")
        self.group_sync_count[gid] = self.group_sync_count.get(gid, 0) + 1
        if members == 1:
            return tree_map(lambda l: l[0], stacked)
        if len(group.axes) > 1:
            shape = tuple(group.sizes)
            split = tree_map(lambda l: l.reshape(shape + tuple(l.shape[1:])),
                             stacked)
            synced = group.emulate_reduce(split, mean=mean)
            return tree_map(
                lambda l: l.reshape((members,) + tuple(l.shape[len(shape):]))[0],
                synced)
        synced = group.emulate_reduce(stacked, mean=mean)
        return tree_map(lambda l: l[0], synced)

    # -- data plane ----------------------------------------------------------
    def push(self, key: Any, tensor: Any, *, group: Any = None,
             at: Optional[float] = None, unit: Optional[int] = None) -> None:
        """Worker push. ``group=gid`` marks ``tensor`` as the group's
        stacked member values: the registered communicator's collective
        reduces them first and the group counts as ONE pusher toward the
        PS barrier — the paper's client-master push.

        ``at`` is the push's simulated arrival time: with a
        ``barrier_timeout``, a push landing more than the timeout after
        its round's first arrival is late — the barrier already released
        without it — and is discarded (``late_pushes``). ``unit`` names
        the pusher for the attached StalenessTracker."""
        self._require_key(key, "push")
        if (self.is_sync and at is not None
                and self.barrier_timeout is not None
                and key in self._first_arrival
                and at - self._first_arrival[key] > self.barrier_timeout):
            self.late_pushes += 1
            return
        if group is not None:
            if group not in self._groups:
                raise KeyError(
                    f"push(group={group!r}) before register_group — attach "
                    "the client's Communicator first")
            tensor = self.group_reduce(group, tensor)
        agg = local_reduce(tensor) if isinstance(tensor, list) else tensor
        self.push_count[key] += 1
        raw = _nbytes(agg)
        self.pushed_bytes_uncompressed += raw
        if self.wire_dtype == "bf16":
            # pure-cast wire: half the bytes, no scales, per leaf
            agg = tree_map(lambda l: l.to(torch.bfloat16).to(l.dtype), agg)
            self.pushed_bytes += sum(l.numel() * 2 for l in tree_leaves(agg))
        elif self.wire_dtype == "int8":
            if self._flat_elastic_ok(agg):
                # the wire form is ONE packed int8 buffer + per-bucket
                # scales, quantized per push; the count is the unpadded
                # payload
                self.pushed_bytes += wire_nbytes(flatbuf.spec_for(agg).payload)
                agg = wire_packed(agg)  # what the server receives
            else:
                # the per-leaf QBLOCK codec: codes + one scale per 1024
                # values of each leaf
                codes, scales = compress(agg)
                self.pushed_bytes += compressed_bytes(agg)
                agg = decompress(codes, scales, agg)  # what the server sees
        else:
            self.pushed_bytes += raw
        if self.is_sync:
            pend = self._pending.setdefault(key, [])
            if not pend and at is not None:
                self._first_arrival[key] = at
            pend.append(agg)
            if len(pend) >= self.expected_pushers:
                self._release(key, unit=unit)
        else:
            self._apply(key, agg, unit=unit)

    def _release(self, key: Any, *, unit: Optional[int] = None) -> None:
        """Release the sync barrier of ``key`` with the pushes it holds."""
        pend = self._pending.pop(key)
        self._first_arrival.pop(key, None)
        self.last_barrier_count = len(pend)
        self._apply(key, self._barrier_sum(pend), count=len(pend), unit=unit)

    @staticmethod
    def _barrier_sum(pend: list) -> Any:
        """Sum the barrier's pushes in arrival order. A tree of several
        float leaves is summed as ONE packed f32 buffer (one add per
        pusher) and unpacked once; otherwise leaf by leaf."""
        leaves = tree_leaves(pend[0])
        if len(leaves) > 1 and _all_float(pend[0]):
            spec = flatbuf.spec_for(pend[0])
            buf = spec.pack(pend[0])
            for other in pend[1:]:
                buf = buf + spec.pack(other)
            return spec.unpack(buf)
        total = pend[0]
        for other in pend[1:]:
            total = tree_map(torch.add, total, other)
        return total

    def pull(self, key: Any, num_dst: int = 1, *,
             unit: Optional[int] = None,
             now: Optional[float] = None) -> list:
        """The server value, once per destination slot.

        Graceful degradation (paper §2-3): with ``barrier_timeout`` and
        ``now`` past ``first_arrival + timeout``, an incomplete sync
        barrier RELEASES with the pushes that made it instead of raising;
        ``degraded_syncs`` counts the short releases and
        ``last_barrier_count`` records how many pushes each summed.
        ``unit`` records the pull on the attached StalenessTracker."""
        self._require_key(key, "pull")
        if key in self._pending:
            opened = self._first_arrival.get(key)
            # the runners put a round's deadline at ``opened + timeout``,
            # whose difference from ``opened`` can round below the timeout:
            # the reference raises there; the sum form releases
            timed_out = (
                self.barrier_timeout is not None and now is not None
                and opened is not None
                and (now - opened >= self.barrier_timeout
                     or now >= opened + self.barrier_timeout))
            if not timed_out:
                raise RuntimeError(
                    f"pull of key {key!r} while sync barrier incomplete "
                    f"({len(self._pending[key])}/{self.expected_pushers} "
                    "pushes)")
            self.degraded_syncs += 1
            self._release(key)
        v = self._values[key]
        if self._staleness is not None and unit is not None:
            self._staleness.on_pull(unit)
        return [v for _ in range(num_dst)]

    def pushpull(self, key: Any, tensor: Any, num_dst: int = 1, *,
                 group: Any = None) -> list:
        """Fused push + pull (§4.2.4): a push followed by an immediate
        pull. For sync types the pull still honors the cross-group
        barrier, so the LAST group's pushpull releases it."""
        self.push(key, tensor, group=group)
        return self.pull(key, num_dst)

    # -- server rules ---------------------------------------------------------
    def _apply(self, key: Any, pushed: Any, *, count: Optional[int] = None,
               unit: Optional[int] = None) -> None:
        rule = self._rule
        stale = None
        if self._staleness is not None and unit is not None:
            stale = self._staleness.on_apply(unit)
        if rule.kind == "assign":
            self._values[key] = pushed
        elif rule.kind == "optimize":
            rescale = rule.rescale
            if count is not None and count != self._static_expected:
                # a short barrier sums ``count`` pushers where the rescale
                # assumed the full roster: keep the step magnitude
                rescale = rescale * (self._static_expected / count)
            grad = tree_map(lambda g: g * rescale, pushed)
            if self._stale_scale and stale:
                # damp an s-stale push by 1/(1+s), one packed multiply
                factor = 1.0 / (1.0 + stale)
                if _all_float(grad):
                    grad = scale_packed(grad, factor)
                else:
                    grad = tree_map(lambda g: g * factor, grad)
            new_v, new_s = rule.optimizer.update(
                grad, self._opt_state[key], self._values[key])
            self._values[key] = new_v
            self._opt_state[key] = new_s
        elif rule.kind == "elastic":
            if self._flat_elastic_ok(pushed):
                # Elastic1 on the packed FlatBuffer: one fused launch for
                # the whole tree, only the center written
                self._values[key] = elastic_server_packed(
                    pushed, self._values[key], rule.alpha)
            else:
                self._values[key] = elastic_server_update(
                    self._values[key], pushed, rule.alpha)

    def _flat_elastic_ok(self, tree: Any) -> bool:
        """Whether the packed fused rule serves this push: elastic rule,
        flat path on, and every leaf a float the f32 buffer carries."""
        if not (self.flat_exchange and self._rule.kind == "elastic"):
            return False
        return _all_float(tree)

    # -- introspection ---------------------------------------------------------
    def value(self, key: Any) -> Any:
        self._require_key(key, "value")
        return self._values[key]

    def keys(self) -> list:
        return list(self._values)

    def server_of(self, key: Any) -> int:
        """Key placement across the server shards: crc32 of the key string
        (not ``hash()``, which Python salts per process)."""
        return zlib.crc32(str(key).encode()) % self.num_servers

    def bytes_per_server_per_sync(self, key: Any) -> int:
        """Ingress bytes one server receives per global sync of this key —
        the contention quantity of Fig. 12."""
        return _nbytes(self._values[key]) * self.expected_pushers // self.num_servers
