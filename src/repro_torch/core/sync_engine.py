"""SyncEngine: the strategy layer behind the lowerable sync modes.

The step builder (``launch/train.py``) drives one interface and the choice
of HOW a step syncs and updates is made once, here (``make_sync_engine``):

  init_opt              optimizer-state layout (flat state buffer vs
                        per-leaf pytree)
  update                the sync+update leg (pack -> reduce-scatter ->
                        fused kernel -> allgather -> unpack, vs per-leaf
                        ``Optimizer.update``)
  update_overlapped     the post-backward half of the overlapped step
                        (``SyncConfig.overlap``): fused kernel on the
                        bucket-major schedule shard + the one trailing
                        allgather; the per-bucket reduce-scatter legs ran
                        inside the staged backward (``launch/train``)
  exchange_multiclient  the elastic leg for C stacked replicas (packed
                        single-launch kernel vs per-leaf tree maps)
  check_opt_layout      loud guard that the state factory and the step
                        factory agreed on the layout
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.core import comm as comm_lib, flatbuf
from repro_torch.core.elastic import (
    elastic_exchange_multiclient,
    elastic_exchange_multiclient_flat,
)
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.optim.sgd import (
    FLAT_STATE_STREAMS,
    Optimizer,
    flat_hp,
    optstate_sched_init,
    optstate_shard_init,
    overlap_update,
    scatter_update_gather,
)
from repro_torch.tree import tree_leaves


def flat_update_supported(optimizer: Optimizer, sync: SyncConfig,
                          mesh=None) -> bool:
    """Whether the packed fused-kernel update can replace per-leaf:
    a lowerable optimizer (momentum SGD with f32 state, AdaGrad or AdamW)
    and no ambient mesh."""
    hyper = optimizer.hyper
    if not (sync.fused_update and sync.mode in ("mpi_sgd", "mpi_esgd")
            and mesh is None):
        return False
    name = hyper.get("name", "")
    name = name[5:] if name.startswith("flat_") else name
    if name == "sgd":
        return (hyper.get("momentum", 0.0) > 0.0
                and hyper.get("state_dtype") in (None, torch.float32))
    return name in FLAT_STATE_STREAMS


def flat_exchange_active(sync: SyncConfig, mesh=None) -> bool:
    """Whether the elastic leg runs packed (FlatBuffer + fused kernel)."""
    return sync.mode == "mpi_esgd" and sync.flat_exchange and mesh is None


@dataclass(frozen=True)
class SyncEngine:
    """Per-leaf strategy (the GSPMD path, custom optimizers, SGD with a
    bf16 momentum).

    ``comm`` is the gradient group the update leg syncs over."""

    optimizer: Optimizer
    sync: SyncConfig
    comm: comm_lib.Communicator = comm_lib.LOCAL
    flat_exchange: bool = False
    spec: Optional[flatbuf.FlatBuffer] = None

    fused = False  # class attr, not a field: FlatEngine overrides

    def init_opt(self, params: Any) -> Any:
        return self.optimizer.init(params)

    def update(self, grads: Any, opt_state: Any, params: Any):
        return self.optimizer.update(grads, opt_state, params)

    def check_opt_layout(self, opt_state: Any, num_clients: int = 1) -> None:
        if isinstance(opt_state, torch.Tensor) or _is_flat_adamw_state(opt_state):
            raise ValueError(
                "per-leaf update got a flat fused state buffer — build the "
                "train state and the step from the same SyncConfig, or set "
                "SyncConfig.fused_update=False for both")

    def exchange_multiclient(self, client_params: Any, center: Any, alpha):
        """One elastic exchange over C stacked replicas (eqs. 2+3)."""
        if self.flat_exchange:
            return elastic_exchange_multiclient_flat(client_params, center,
                                                     alpha, spec=self.spec)
        return elastic_exchange_multiclient(client_params, center, alpha)


def _is_flat_adamw_state(opt_state: Any) -> bool:
    """The flat AdamW layout ({"mv": (2, n), "t": ()}) — distinct from the
    per-leaf adamw pytree ({"m": tree, "v": tree, "t": ()})."""
    return isinstance(opt_state, dict) and set(opt_state) == {"mv", "t"}


@dataclass(frozen=True)
class FlatEngine(SyncEngine):
    """Flat-buffer strategy: the whole gradient pytree rides one packed
    buffer and ONE fused kernel, with the optimizer-state streams stored
    as flat buffers in the declared stream dtype."""

    fused = True
    # backward-overlapped path (SyncConfig.overlap): the schedule over the
    # STAGED param spec (bucket == backward stage), built at the gradient
    # group's p. None = the monolithic leg.
    schedule: Optional[flatbuf.BucketSchedule] = None
    # the step-invariant kernel hyperparameters, one f32 vector per device
    _hp: dict = field(default_factory=dict, repr=False, compare=False)

    def _num_rings(self) -> int:
        return self.comm.rings_for(self.spec.nbytes)

    def _hp_on(self, device) -> torch.Tensor:
        hp = self._hp.get(device)
        if hp is None:
            hp = self._hp[device] = flat_hp(self.optimizer.hyper, device)
        return hp

    def init_opt(self, params: Any) -> Any:
        # local (p=1) geometry; the shard driver inits per device with
        # optstate_shard_init / optstate_sched_init at its p
        device = tree_leaves(params)[0].device
        if self.schedule is not None:
            return optstate_sched_init(self.optimizer.hyper,
                                       self.schedule.with_p(1), device=device)
        return optstate_shard_init(self.optimizer.hyper, self.spec, 1,
                                   self._num_rings(), device=device)

    def update(self, grads: Any, opt_state: Any, params: Any):
        hp = self._hp_on(tree_leaves(params)[0].device)
        return scatter_update_gather(
            self.spec, grads, params, opt_state,
            hyper=self.optimizer.hyper, comm=self.comm, hp=hp)

    def update_overlapped(self, g_shard: torch.Tensor, staged_params: Any,
                          opt_state: Any):
        """The post-backward half of the overlapped step: fused kernel on
        the bucket-major shard + the ONE trailing allgather. ``g_shard``
        comes from the staged grad fn (per-bucket reduce-scatter legs
        already issued mid-backward); returns staged params."""
        return overlap_update(
            self.schedule, g_shard, staged_params, opt_state,
            hyper=self.optimizer.hyper, comm=self.comm,
            hp=self._hp_on(g_shard.device))

    def check_opt_layout(self, opt_state: Any, num_clients: int = 1) -> None:
        if self.optimizer.hyper.get("name", "").endswith("adamw"):
            if not _is_flat_adamw_state(opt_state):
                raise ValueError(
                    "fused adamw sync path expects the flat {'mv', 't'} "
                    "state, but the train state carries a per-leaf opt "
                    "state — build both from the same SyncConfig")
            buf, streams = opt_state["mv"], 2
        else:
            if not isinstance(opt_state, torch.Tensor):
                raise ValueError(
                    "fused sync path expects the flat state buffer, but the "
                    "train state carries a per-leaf opt state — build both "
                    "from the same SyncConfig")
            buf, streams = opt_state, 1
        # C > 1 updates every client in its local (p=1) geometry
        p = 1 if num_clients > 1 else self.comm.resolve_size()
        if self.schedule is not None:
            # overlapped layout: bucket-major concat of per-bucket chunks
            want = self.schedule.with_p(p).shard_size
        else:
            want = flatbuf.shard_size(self.spec, p, self.sync.num_rings,
                                      self.sync.bucket_bytes)
        per_client = buf.numel() // (streams * max(num_clients, 1))
        if per_client != want:
            raise ValueError(
                f"fused state shard has {per_client} elements per stream "
                f"but the {p}-way geometry needs {want} — state for a "
                "sharded run comes from optim.sgd.optstate_shard_init("
                "hyper, spec, p, ...)")


def make_sync_engine(optimizer: Optimizer, sync: SyncConfig, mesh=None, *,
                     comm: Optional[comm_lib.Communicator] = None,
                     spec: Optional[flatbuf.FlatBuffer] = None,
                     schedule: Optional[flatbuf.BucketSchedule] = None,
                     ) -> SyncEngine:
    """Resolve the strategy for (optimizer, sync, mesh) once. ``comm`` is
    the gradient group the update leg syncs over (trivial when omitted).
    ``spec`` (the param-tree FlatBuffer, ``launch.train.grad_spec``) is
    required when a flat leg engages; ``schedule`` (``launch.train.
    overlap_schedule``) when ``sync.overlap`` is set.

    With a ``mesh`` (the GSPMD path: DTensor state laid out by
    ``sharding.param_specs``) both legs stay per-leaf and ``comm`` is the
    trivial group — the DTensor redistributes are the collectives. The
    shard driver's process mesh passes no mesh here: it hands its
    gradient group as ``comm=``."""
    if comm is None:
        comm = comm_lib.from_sync(sync)
    fused = flat_update_supported(optimizer, sync, mesh)
    flat_ex = flat_exchange_active(sync, mesh)
    if fused and spec is None:
        raise ValueError("flat-update engine needs the FlatBuffer spec")
    if sync.overlap and not fused:
        raise ValueError(
            "SyncConfig.overlap=True but the fused flat update cannot "
            "engage for this (optimizer, sync, mesh) — overlap rides the "
            "fused path only (core.sync_engine.flat_update_supported): "
            "use momentum SGD / AdaGrad / AdamW with fused_update=True "
            "and no ambient mesh")
    if sync.overlap and schedule is None:
        raise ValueError(
            "overlap engine needs the BucketSchedule — build it with "
            "launch.train.overlap_schedule(model, sync, p) from the "
            "model's staged param spec")
    if fused:
        return FlatEngine(optimizer, sync, comm=comm, flat_exchange=flat_ex,
                          spec=spec, schedule=schedule)
    return SyncEngine(optimizer, sync, comm=comm, flat_exchange=flat_ex,
                      spec=spec)
