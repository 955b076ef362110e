"""The six parallel-SGD modes of the paper's evaluation (§7;
``repro/core/algorithms.py``):

  dist-SGD   pure PS, synchronous           (paper fig. 6, #clients=#workers)
  mpi-SGD    MPI clients + PS, synchronous  (fig. 6)
  dist-ASGD  pure PS, asynchronous          (fig. 7, #clients=#workers)
  mpi-ASGD   sync inside client, async push (fig. 7)
  dist-ESGD  elastic averaging per worker   (fig. 8, #clients=#workers)
  mpi-ESGD   local sync-SGD inside client, elastic averaging at PS (fig. 8)

Each mode drives the KVStore API the paper's pseudo-code uses: per-key
push / pull, the server-side optimizer (``set_optimizer``) or elastic
rule (``set_elastic``), and the intra-client tensor allreduce of the
client's registered group. Wall time is *simulated* with the α-β-γ cost
model (``core.cost_model.testbed``, the paper's network) and the
numpy-seeded jitter of ``core.scheduler``, exactly as the reference
draws it, so the simulated clock and the async completion order equal
the reference's; the gradient math is real PyTorch on real data.

``run`` takes ``init_fn(generator)``, a CPU ``torch.Generator`` seeded
with ``cfg.seed``, where the reference passes ``jax.random.key(seed)``;
``grad_fn(params, batch) -> (loss, grads)``; ``eval_fn(params) ->
float``; and ``make_pipeline(worker)`` with ``batch_at(epoch, step)``.
It runs on the card unless the caller passes ``device="cpu"``.

``AlgoConfig.faults`` injects a deterministic fault schedule
(``core.faults``): the sync modes run ``_run_sync_faulted`` (a dead
client misses the PS barrier, which releases short after
``barrier_timeout``, then the client ``Membership`` evicts it; straggles
and delays stretch arrivals, drops ride the retry/backoff policy, late
pushes are discarded), the async and elastic runners drop a killed unit
from the event engine and lose or delay its pushes. The simulated clock,
``degraded_syncs``, ``late_pushes``, ``live_clients`` and
``membership_epochs`` equal the reference's. ``server_faults``,
``checkpoint_every``, ``restarts`` and ``restart_backoff`` configure the
socket tier's servers and supervisor; the in-process runners ignore them,
as they ignore ``restart`` events.
"""
from __future__ import annotations

from dataclasses import InitVar, dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import cost_model, flatbuf
from repro_torch.core.client import group_workers
from repro_torch.core.collectives import check_wire_dtype
from repro_torch.core.comm import (CollectivePolicy, Communicator,
                                   filter_mirrors, resolve_policy)
from repro_torch.core.elastic import elastic_client_packed, elastic_client_update
from repro_torch.core.faults import FaultInjector, delivery_time, injector
from repro_torch.core.kvstore import KVStore
from repro_torch.core.membership import Membership
from repro_torch.core.scheduler import AsyncEngine, StalenessTracker, UnitTiming
from repro_torch.launch.train import resolve_device
from repro_torch.optim.sgd import (
    Optimizer,
    adagrad,
    adamw,
    flat_adagrad,
    flat_adamw,
    flat_sgd,
    sgd,
)
from repro_torch.tree import tree_leaves, tree_map

MODES = ("dist_sgd", "mpi_sgd", "dist_asgd", "mpi_asgd", "dist_esgd", "mpi_esgd")

#: the flat-field defaults AlgoConfig ships (the simulated worker group
#: runs 2 rings) — the base point the flat kwargs resolve against
_ALGO_BASE = CollectivePolicy(method="multi_ring", num_rings=2)


@dataclass(frozen=True)
class AlgoConfig:
    mode: str
    num_workers: int = 12
    num_clients: int = 2          # ignored for dist_* (== num_workers)
    num_servers: int = 2
    lr: float = 0.1
    momentum: float = 0.9
    esgd_alpha: float = 0.5
    esgd_interval: int = 64       # the paper's INTERVAL
    epochs: int = 4
    steps_per_epoch: int = 40
    compute_time: float = 0.5     # nominal s/batch (paper: resnet50 on K80s)
    jitter: float = 0.15
    model_bytes: float = 100e6    # resnet-50 ~ 25M params fp32
    seed: int = 0
    net: cost_model.NetParams = field(default_factory=cost_model.testbed)
    # flat mirror of ``policy.method``
    allreduce_method: str = "multi_ring"
    # removed: wire_dtype="int8" is the one compression knob (hard error)
    compress_push: bool = False
    # low-precision wire: the intra-client collective hops (the worker
    # group's policy) and the ESGD PS push leg — None/"f32", "bf16", "int8"
    wire_dtype: Optional[str] = None
    # worker/server update rule: sgd / adagrad / adamw
    optimizer: str = "sgd"
    # fused flat-buffer optimizer step (one kernel over the packed grads)
    fused_update: bool = True
    # flat elastic leg: eqs. (2)/(3) on the packed FlatBuffer through the
    # fused kernels (the KVStore rule and the client update)
    flat_exchange: bool = True
    bucket_bytes: Optional[int] = None
    # backward overlap: the simulated step pays only the exposed
    # remainder of the intra-client reduce-scatter
    overlap: bool = False
    overlap_buckets: int = 4
    # fault injection (core/faults.py): a FaultSchedule or its compact
    # string form ("kill@12:unit=1;straggle@0:unit=3:factor=4"); None runs
    # the clean path
    faults: Any = None
    # sync-barrier graceful degradation (KVStore): seconds past a round's
    # first arrival before the barrier releases with the survivors;
    # required for kill/drop schedules in the sync modes
    barrier_timeout: Optional[float] = None
    # async server rule: damp an s-stale push by 1/(1+s)
    staleness_scaling: bool = False
    # dropped-push retry policy: 1 + push_retries delivery attempts,
    # doubling backoff starting at push_backoff seconds
    push_retries: int = 2
    push_backoff: float = 0.05
    # crash recovery of the socket tier (its KV snapshots, supervised
    # respawns and the servers' own fault schedule): the in-process
    # runners ignore all four, as the reference's do
    checkpoint_every: int = 0
    restarts: int = 0
    restart_backoff: float = 0.05
    server_faults: Any = None
    # the policy the mirror knobs were backfilled from (dataclasses.replace
    # passes it back so __post_init__ can tell a changed mirror from one
    # restating the previous policy). Never pass it yourself.
    policy_src: Optional[CollectivePolicy] = field(
        default=None, repr=False, compare=False)
    # -- the ONE policy field (canonical; the flat knobs mirror it) --------
    policy: InitVar[Optional[CollectivePolicy]] = None

    def __post_init__(self, policy: Optional[CollectivePolicy] = None):
        if self.compress_push:
            raise ValueError(
                "AlgoConfig(compress_push=True) was removed — it is the "
                "int8 wire: pass wire_dtype='int8' instead")
        defaults = {"method": "multi_ring", "bucket_bytes": None,
                    "wire_dtype": None, "overlap": False,
                    "overlap_buckets": 4}
        flat = {
            "method": self.allreduce_method,
            "bucket_bytes": self.bucket_bytes, "wire_dtype": self.wire_dtype,
            "overlap": self.overlap, "overlap_buckets": self.overlap_buckets,
        }
        flat = filter_mirrors(flat, defaults=defaults,
                              prior=self.policy_src)
        if policy is None and flat.get("overlap"):
            flat["num_rings"] = 1   # overlap runs a single ring schedule
        pol = resolve_policy(policy, flat, base=_ALGO_BASE,
                             where="AlgoConfig")
        pol.validate(where="AlgoConfig")
        object.__setattr__(self, "policy", pol)
        object.__setattr__(self, "policy_src", pol)
        object.__setattr__(self, "allreduce_method", pol.method)
        object.__setattr__(self, "bucket_bytes", pol.bucket_bytes)
        object.__setattr__(self, "wire_dtype", pol.wire_dtype)
        object.__setattr__(self, "overlap", pol.overlap)
        object.__setattr__(self, "overlap_buckets", pol.overlap_buckets)

    @property
    def collective_wire_dtype(self) -> Optional[str]:
        """Wire dtype of the intra-client collective hops (None =
        full precision) — ``policy.wire``."""
        return check_wire_dtype(self.policy.wire_dtype, where="AlgoConfig")

    @property
    def effective_wire_dtype(self) -> Optional[str]:
        """Wire dtype of the PS push leg: the same one knob."""
        return self.collective_wire_dtype

    @property
    def effective_clients(self) -> int:
        return self.num_workers if self.mode.startswith("dist") else self.num_clients

    @property
    def workers_per_client(self) -> int:
        return self.num_workers // self.effective_clients


@dataclass
class History:
    times: list[float] = field(default_factory=list)
    epochs: list[int] = field(default_factory=list)
    metrics: list[float] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)
    mean_staleness: float = 0.0
    epoch_time: float = 0.0
    # robustness accounting (0/full on clean runs)
    degraded_syncs: int = 0
    late_pushes: int = 0
    live_clients: int = 0
    membership_epochs: int = 0
    # bytes the PS tier received on its wire (KVStore.pushed_bytes)
    pushed_bytes: int = 0


GradFn = Callable[[Any, dict], tuple[torch.Tensor, Any]]
EvalFn = Callable[[Any], float]


def _div(tree: Any, k: int) -> Any:
    """Every leaf divided by ``k`` — through a device tensor: CUDA divides
    by a CPU scalar through its reciprocal, which the CPU does not."""
    d = torch.tensor(float(k), device=tree_leaves(tree)[0].device)
    return tree_map(lambda l: l / d, tree)


def _worker_group(cfg: AlgoConfig) -> Communicator:
    """The intra-client MPI communicator (one per client — every client has
    the same geometry, so one object serves them all): ``workers_per_client``
    ranks over an emulated 'worker' axis, with the config's policy."""
    return Communicator.world(
        ("worker",), (cfg.workers_per_client,), policy=cfg.policy)


def _member_grads(grad_fn: GradFn, params,
                  batches: list[dict]) -> tuple[float, Any]:
    """Per-worker grads of one client, stacked on a leading member dim
    (the group collective's layout)."""
    losses, grads = [], []
    for b in batches:
        l, g = grad_fn(params, b)
        losses.append(float(l))
        grads.append(g)
    stacked = tree_map(lambda *xs: torch.stack(xs), *grads)
    return float(np.mean(losses)), stacked


def _client_grad(grad_fn: GradFn, params, batches: list[dict],
                 group: Communicator) -> tuple[float, Any]:
    """Intra-client step: per-worker grads, group-allreduced (mean) through
    the client's communicator."""
    loss, stacked = _member_grads(grad_fn, params, batches)
    if len(batches) == 1:
        return loss, tree_map(lambda l: l[0], stacked)
    synced = group.emulate_reduce(stacked)
    return loss, _div(tree_map(lambda s: s[0], synced), len(batches))


def _make_opt(cfg: AlgoConfig, params) -> Optimizer:
    """The worker/server update rule: the fused flat-buffer optimizer (one
    kernel over the packed gradient) when enabled, else per leaf."""
    if cfg.optimizer == "adagrad":
        if cfg.fused_update:
            return flat_adagrad(cfg.lr, flatbuf.spec_for(params),
                                bucket_bytes=cfg.bucket_bytes)
        return adagrad(cfg.lr)
    if cfg.optimizer == "adamw":
        if cfg.fused_update:
            return flat_adamw(cfg.lr, flatbuf.spec_for(params),
                              bucket_bytes=cfg.bucket_bytes)
        return adamw(cfg.lr)
    if cfg.optimizer != "sgd":
        raise ValueError(f"optimizer must be sgd/adagrad/adamw, "
                         f"got {cfg.optimizer!r}")
    if cfg.fused_update and cfg.momentum > 0.0:
        # momentum == 0 would still pay a full-model momentum buffer
        return flat_sgd(cfg.lr, cfg.momentum, flatbuf.spec_for(params),
                        bucket_bytes=cfg.bucket_bytes)
    return sgd(cfg.lr, cfg.momentum)


def _comm_times(cfg: AlgoConfig) -> dict[str, float]:
    per_client = cfg.workers_per_client
    intra = cost_model.allreduce_time(
        cfg.model_bytes, per_client, cfg.net, cfg.allreduce_method,
        wire_dtype=cfg.collective_wire_dtype,
    )
    if cfg.overlap:
        # exposed comm time only: the hidden reduce-scatter fraction rides
        # behind cfg.compute_time in the step accounting
        bb = [cfg.model_bytes / cfg.overlap_buckets] * cfg.overlap_buckets
        intra = cost_model.overlapped_step_time(
            cfg.compute_time, bb, per_client, cfg.net,
            wire_dtype=cfg.collective_wire_dtype) - cfg.compute_time
    ps = cost_model.ps_pushpull_time(
        cfg.model_bytes, cfg.effective_clients, cfg.num_servers, cfg.net,
        wire_dtype=cfg.effective_wire_dtype,
    )
    return {"intra": intra, "ps": ps}


def _members(idents, num_workers: int, client: int) -> list[int]:
    return [w for w in range(num_workers) if idents[w].mpi.client == client]


def _injector(cfg: AlgoConfig) -> Optional[FaultInjector]:
    """The config's fault injector (None when the schedule is empty: the
    clean path runs)."""
    return injector(cfg.faults, seed=cfg.seed)


def _client_membership(cfg: AlgoConfig, C: int) -> Membership:
    """The PS tier's membership: clients over an emulated 'client' axis,
    so every epoch change re-splits a Communicator (the group a deployment
    would MPI_Comm_split over the survivors)."""
    return Membership(
        C, Communicator.world(
            ("client",), (C,),
            policy=CollectivePolicy(method=cfg.policy.method)))


def run(cfg: AlgoConfig, init_fn: Callable[[torch.Generator], Any],
        grad_fn: GradFn, eval_fn: EvalFn, make_pipeline: Callable[[int], Any],
        *, device="cuda") -> History:
    if cfg.mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if cfg.num_workers % cfg.effective_clients:
        raise ValueError("workers must divide into clients evenly")
    device = resolve_device(device)
    runner = {
        "dist_sgd": _run_sync, "mpi_sgd": _run_sync,
        "dist_asgd": _run_async, "mpi_asgd": _run_async,
        "dist_esgd": _run_esgd, "mpi_esgd": _run_esgd,
    }[cfg.mode]

    def init(seed: int) -> Any:
        params = init_fn(torch.Generator().manual_seed(seed))
        where = {str(l.device) for l in tree_leaves(params)}
        if where != {str(torch.empty(0, device=device).device)}:
            raise ValueError(f"init_fn returned params on {sorted(where)}; "
                             f"run(device={str(device)!r}) wants them there")
        return params

    return runner(cfg, init, grad_fn, eval_fn, make_pipeline)


# ---------------------------------------------------------------------------
# synchronous (fig. 6): Push(grads); Pull(grads); SGD.Update locally
# ---------------------------------------------------------------------------

def _run_sync(cfg, init, grad_fn, eval_fn, make_pipeline) -> History:
    inj = _injector(cfg)
    if inj is not None:
        return _run_sync_faulted(cfg, init, grad_fn, eval_fn, make_pipeline,
                                 inj)
    return _run_sync_clean(cfg, init, grad_fn, eval_fn, make_pipeline)


def _run_sync_clean(cfg, init, grad_fn, eval_fn, make_pipeline) -> History:
    C = cfg.effective_clients
    idents = group_workers(cfg.num_workers, C)
    pipelines = [make_pipeline(w) for w in range(cfg.num_workers)]
    params = init(cfg.seed)
    # fig. 6: Push(grads); Pull(grads) returns the global SUM (server rule
    # "assign" after the sync barrier); SGD.Update runs on the worker with
    # rescale = 1/num_workers of the worker-mean grads
    kv = KVStore.create("sync_mpi" if cfg.mode == "mpi_sgd" else "dist_sync",
                        num_workers=cfg.num_workers, num_servers=cfg.num_servers,
                        num_clients=C)
    kv.init("grads", tree_map(torch.zeros_like, params))
    group = _worker_group(cfg)
    for c in range(C):
        kv.register_group(c, group)
    opt = _make_opt(cfg, params)
    opt_state = opt.init(params)

    comm = _comm_times(cfg)
    rng = np.random.default_rng(cfg.seed)
    now = 0.0
    hist = History()
    step_times = []
    for epoch in range(cfg.epochs):
        for step in range(cfg.steps_per_epoch):
            losses = []
            for c in range(C):
                batches = [pipelines[w].batch_at(epoch, step)
                           for w in _members(idents, cfg.num_workers, c)]
                loss, stacked = _member_grads(grad_fn, params, batches)
                # the group collective runs INSIDE kv.push; the client-sum
                # crosses to the PS tier as one pusher
                kv.push("grads", stacked, group=c)
                losses.append(loss)
            total = kv.pull("grads")[0]
            params, opt_state = opt.update(_div(total, cfg.num_workers),
                                           opt_state, params)
            # simulated wall time: slowest worker's compute + comms
            compute = max(
                cfg.compute_time * rng.lognormal(0, cfg.jitter)
                for _ in range(cfg.num_workers)
            )
            dt = compute + comm["intra"] + comm["ps"]
            now += dt
            step_times.append(dt)
            hist.losses.append(float(np.mean(losses)))
        hist.times.append(now)
        hist.epochs.append(epoch)
        hist.metrics.append(eval_fn(params))
    hist.epoch_time = float(np.mean(step_times)) * cfg.steps_per_epoch
    hist.live_clients = C
    hist.pushed_bytes = kv.pushed_bytes
    return hist


def _run_sync_faulted(cfg, init, grad_fn, eval_fn, make_pipeline,
                      inj: FaultInjector) -> History:
    """The synchronous modes under a fault schedule. Dead clients miss the
    PS barrier; the FIRST missed round degrades via barrier_timeout
    (survivor release + rescale), after which the Membership evicts them
    (epoch bump + Communicator re-split) and later barriers are full
    barriers of the survivor group. Straggle/delay stretch a client's
    arrival; drops ride the retry/backoff policy; pushes past the deadline
    are discarded as late by the store."""
    C = cfg.effective_clients
    if (cfg.barrier_timeout is None
            and inj.schedule.kinds & {"kill", "drop"}):
        raise ValueError(
            f"mode {cfg.mode!r} has a sync PS barrier: a kill/drop fault "
            "schedule would deadlock it — set AlgoConfig.barrier_timeout so "
            "the barrier can release with the survivor group")
    idents = group_workers(cfg.num_workers, C)
    pipelines = [make_pipeline(w) for w in range(cfg.num_workers)]
    params = init(cfg.seed)
    kv = KVStore.create("sync_mpi" if cfg.mode == "mpi_sgd" else "dist_sync",
                        num_workers=cfg.num_workers, num_servers=cfg.num_servers,
                        num_clients=C, barrier_timeout=cfg.barrier_timeout)
    kv.init("grads", tree_map(torch.zeros_like, params))
    group = _worker_group(cfg)
    for c in range(C):
        kv.register_group(c, group)
    live = _client_membership(cfg, C)
    kv.attach_membership(live)
    opt = _make_opt(cfg, params)
    opt_state = opt.init(params)

    comm = _comm_times(cfg)
    wpc = cfg.workers_per_client
    rng = np.random.default_rng(cfg.seed)
    now = 0.0
    hist = History()
    step_times = []
    for epoch in range(cfg.epochs):
        for step in range(cfg.steps_per_epoch):
            gstep = epoch * cfg.steps_per_epoch + step
            newly_dead = [c for c in live.live if inj.is_killed(c, gstep)]
            losses, arrivals, pushes = [], {}, {}
            for c in live.live:
                if c in newly_dead:
                    continue  # died before this round's compute
                members = _members(idents, cfg.num_workers, c)
                batches = [pipelines[w].batch_at(epoch, step) for w in members]
                loss, stacked = _member_grads(grad_fn, params, batches)
                draws = [rng.lognormal(0, cfg.jitter) for _ in members]
                compute = cfg.compute_time * max(draws)
                leg = (compute * inj.straggle_factor(c, gstep)
                       + inj.delay(c, gstep))
                arrivals[c] = now + leg + comm["intra"]
                pushes[c] = inj.corrupt(stacked, c, gstep)
                losses.append(loss)
            deliver = {}
            for c in sorted(arrivals):
                at = delivery_time(inj, c, gstep, arrivals[c],
                                   retries=cfg.push_retries,
                                   backoff=cfg.push_backoff)
                if at is not None:
                    deliver[c] = at
            if deliver:
                first = min(deliver.values())
                deadline = (float("inf") if cfg.barrier_timeout is None
                            else first + cfg.barrier_timeout)
                in_time = [c for c in deliver if deliver[c] <= deadline]
                for c in sorted(deliver, key=lambda c: (deliver[c], c)):
                    # the store discards deliveries past the deadline
                    # (late_pushes); in-time ones fill the barrier
                    kv.push("grads", pushes[c], group=c, at=deliver[c], unit=c)
                release = (max(deliver[c] for c in in_time)
                           if len(in_time) == kv.expected_pushers
                           else deadline)
                total = kv.pull("grads", now=release)[0]
                k = kv.last_barrier_count or len(in_time)
                params, opt_state = opt.update(_div(total, k * wpc),
                                               opt_state, params)
            else:
                # every live push lost this round: no update, the round
                # still burns the timeout waiting
                release = now + (cfg.barrier_timeout or cfg.compute_time)
            dt = release + comm["ps"] - now
            now = release + comm["ps"]
            step_times.append(dt)
            if losses:
                hist.losses.append(float(np.mean(losses)))
            for c in newly_dead:
                # the missed barrier IS the failure detector: evict after
                # the degraded round, shrinking later barriers
                live.fail(c)
        hist.times.append(now)
        hist.epochs.append(epoch)
        hist.metrics.append(eval_fn(params))
    hist.epoch_time = float(np.mean(step_times)) * cfg.steps_per_epoch
    hist.degraded_syncs = kv.degraded_syncs
    hist.late_pushes = kv.late_pushes
    hist.live_clients = live.live_count
    hist.membership_epochs = live.epoch
    hist.pushed_bytes = kv.pushed_bytes
    return hist


# ---------------------------------------------------------------------------
# asynchronous (fig. 7): Push(grads); Pull(params) — server runs optimizer
# ---------------------------------------------------------------------------

def _unit_timing(cfg: AlgoConfig, C: int) -> list[UnitTiming]:
    return [UnitTiming(cfg.compute_time, cfg.jitter,
                       np.random.default_rng((cfg.seed, u)))
            for u in range(C)]


def _run_async(cfg, init, grad_fn, eval_fn, make_pipeline) -> History:
    C = cfg.effective_clients
    inj = _injector(cfg)
    live = _client_membership(cfg, C) if inj is not None else None
    idents = group_workers(cfg.num_workers, C)
    pipelines = [make_pipeline(w) for w in range(cfg.num_workers)]
    params0 = init(cfg.seed)
    kv = KVStore.create("async_mpi" if cfg.mode == "mpi_asgd" else "dist_async",
                        num_workers=cfg.num_workers, num_servers=cfg.num_servers,
                        num_clients=C)
    kv.init("params", params0)
    kv.set_optimizer(_make_opt(cfg, params0), rescale=1.0)
    group = _worker_group(cfg)
    for c in range(C):
        kv.register_group(c, group)
    if live is not None:
        kv.attach_membership(live)

    comm = _comm_times(cfg)
    # contention: concurrent pushers share the server link — async pushes
    # overlap, so charge the expected concurrency factor
    iter_time = cfg.compute_time + comm["intra"]
    solo_push = cost_model.ps_pushpull_time(
        cfg.model_bytes, 1, cfg.num_servers, cfg.net)
    concurrency = max(1.0, C * solo_push / max(iter_time + solo_push, 1e-9))
    push_time = solo_push * concurrency

    engine = AsyncEngine(C, _unit_timing(cfg, C))
    tracker = StalenessTracker()
    # the tracker rides the store: push(unit=)/pull(unit=) record apply /
    # pull versions, and (opt-in) the rule damps an s-stale push
    kv.attach_staleness(tracker, scale=cfg.staleness_scaling)
    client_params = [params0] * C
    client_iter = [0] * C
    hist = History()
    # an epoch = one pass over every worker's shard: steps_per_epoch * C
    # completions of workers_per_client batches each
    per_epoch = cfg.steps_per_epoch * C
    total = cfg.epochs * per_epoch
    state = {"completions": 0, "losses": []}

    def on_complete(unit: int, now: float) -> Optional[float]:
        it = client_iter[unit]
        if inj is not None and inj.is_killed(unit, it):
            # the unit dies at dispatch: the membership evicts it and the
            # engine never re-queues it; survivors drain the budget
            live.fail(unit)
            return None
        epoch = min(it // cfg.steps_per_epoch, cfg.epochs - 1)
        step = it % cfg.steps_per_epoch
        batches = [pipelines[w].batch_at(epoch, step)
                   for w in _members(idents, cfg.num_workers, unit)]
        loss, g = _client_grad(grad_fn, client_params[unit], batches, group)
        state["losses"].append(loss)
        extra = 0.0
        if inj is not None:
            g = inj.corrupt(g, unit, it)
            at = delivery_time(inj, unit, it, now, retries=cfg.push_retries,
                               backoff=cfg.push_backoff)
            if at is not None:
                extra += (at - now) + inj.delay(unit, it)
                kv.push("params", g, unit=unit)
            else:
                kv.late_pushes += 1  # lost for good: the server never sees it
            extra += (inj.straggle_factor(unit, it) - 1.0) * cfg.compute_time
        else:
            kv.push("params", g, unit=unit)
        client_params[unit] = kv.pull("params", unit=unit)[0]
        client_iter[unit] += 1
        state["completions"] += 1
        if state["completions"] % per_epoch == 0:
            ep = state["completions"] // per_epoch - 1
            hist.times.append(now)
            hist.epochs.append(ep)
            hist.metrics.append(eval_fn(kv.value("params")))
            hist.losses.append(float(np.mean(state["losses"][-per_epoch:])))
        return comm["intra"] + push_time + extra

    for u in range(C):
        tracker.on_pull(u)
    engine.start()
    engine.run(total, on_complete)
    hist.mean_staleness = tracker.mean_staleness()
    hist.epoch_time = engine.now / cfg.epochs
    hist.late_pushes = kv.late_pushes
    hist.live_clients = live.live_count if live is not None else C
    hist.membership_epochs = live.epoch if live is not None else 0
    hist.pushed_bytes = kv.pushed_bytes
    return hist


# ---------------------------------------------------------------------------
# elastic (fig. 8): local SGD; every INTERVAL: Push(params) -> Elastic1 on
# server; Pull(centers); Elastic2 locally
# ---------------------------------------------------------------------------

def _run_esgd(cfg, init, grad_fn, eval_fn, make_pipeline) -> History:
    C = cfg.effective_clients
    inj = _injector(cfg)
    live = _client_membership(cfg, C) if inj is not None else None
    idents = group_workers(cfg.num_workers, C)
    pipelines = [make_pipeline(w) for w in range(cfg.num_workers)]
    params0 = init(cfg.seed)
    kv = KVStore.create("async_mpi" if cfg.mode == "mpi_esgd" else "dist_async",
                        num_workers=cfg.num_workers, num_servers=cfg.num_servers,
                        num_clients=C, wire_dtype=cfg.effective_wire_dtype,
                        flat_exchange=cfg.flat_exchange)
    kv.init("centers", params0)
    kv.set_elastic(cfg.esgd_alpha)
    group = _worker_group(cfg)
    for c in range(C):
        kv.register_group(c, group)

    comm = _comm_times(cfg)
    opt = _make_opt(cfg, params0)
    # the center and every replica start from ONE tree: every update below
    # returns new tensors, none writes into a tree another one holds
    client_params = [params0] * C
    client_opt = [opt.init(params0) for _ in range(C)]
    client_iter = [0] * C

    engine = AsyncEngine(C, _unit_timing(cfg, C))
    hist = History()
    total = cfg.epochs * cfg.steps_per_epoch * C
    state = {"completions": 0, "losses": []}
    per_epoch = cfg.steps_per_epoch * C

    def on_complete(unit: int, now: float) -> Optional[float]:
        it = client_iter[unit]
        if inj is not None and inj.is_killed(unit, it):
            # the dead client's replica is abandoned — the center keeps the
            # mass it already absorbed (eq. 2), ESGD's tolerance story
            live.fail(unit)
            return None
        epoch = min(it // cfg.steps_per_epoch, cfg.epochs - 1)
        step = it % cfg.steps_per_epoch
        batches = [pipelines[w].batch_at(epoch, step)
                   for w in _members(idents, cfg.num_workers, unit)]
        loss, g = _client_grad(grad_fn, client_params[unit], batches, group)
        state["losses"].append(loss)
        comm_cost = comm["intra"]
        if it % cfg.esgd_interval == 0:
            pushed = client_params[unit]
            deliver = True
            if inj is not None:
                pushed = inj.corrupt(pushed, unit, it)
                at = delivery_time(inj, unit, it, now,
                                   retries=cfg.push_retries,
                                   backoff=cfg.push_backoff)
                if at is None:
                    # the exchange is lost: neither Elastic1 nor Elastic2
                    # runs this round, the replica drifts one interval more
                    deliver = False
                    kv.late_pushes += 1
                else:
                    comm_cost += (at - now) + inj.delay(unit, it)
            if deliver:
                # Elastic2 reads the center as it was BEFORE this push
                old_center = kv.value("centers")
                kv.push("centers", pushed)               # Elastic1 on server
                if cfg.flat_exchange:
                    client_params[unit] = elastic_client_packed(
                        client_params[unit], old_center, cfg.esgd_alpha)
                else:
                    client_params[unit] = elastic_client_update(
                        client_params[unit], old_center, cfg.esgd_alpha)
                comm_cost += cost_model.ps_pushpull_time(
                    cfg.model_bytes, 1, cfg.num_servers, cfg.net,
                    wire_dtype=cfg.effective_wire_dtype)
        new_p, new_s = opt.update(g, client_opt[unit], client_params[unit])
        client_params[unit] = new_p
        client_opt[unit] = new_s
        client_iter[unit] += 1
        state["completions"] += 1
        if state["completions"] % per_epoch == 0:
            ep = state["completions"] // per_epoch - 1
            hist.times.append(now)
            hist.epochs.append(ep)
            hist.metrics.append(eval_fn(kv.value("centers")))
            hist.losses.append(float(np.mean(state["losses"][-per_epoch:])))
        if inj is not None:
            comm_cost += (inj.straggle_factor(unit, it) - 1.0) * cfg.compute_time
        return comm_cost

    engine.start()
    engine.run(total, on_complete)
    hist.epoch_time = engine.now / cfg.epochs
    hist.late_pushes = kv.late_pushes
    hist.live_clients = live.live_count if live is not None else C
    hist.membership_epochs = live.epoch if live is not None else 0
    hist.pushed_bytes = kv.pushed_bytes
    return hist
