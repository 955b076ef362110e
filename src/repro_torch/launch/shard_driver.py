"""The shard driver over emulated devices (``repro/launch/shard_driver.py``).

Runs both lowerable modes with the whole train step per device: each
device computes grads on its own batch shard, explicit ring collectives
carry every byte of cross-device traffic, and optimizer state lives
sharded by ``optstate_shard_init``. Which collective runs over which
devices is decided by communicator algebra (``core.comm.sync_comms``):

  mpi_sgd   the gradient group IS the world (C = 1 pure-MPI mode): pack
            grads -> (hierarchical) ring reduce-scatter -> fused optimizer
            kernel on the 1/p shard -> ring allgather
  mpi_esgd  the 'pod' axis is the PS tier: the gradient group is
            everything BUT 'pod', and every INTERVAL steps the sharded
            elastic exchange crosses the 'pod' group (one kernel pass for
            eq. (3) + the packed differences, ring reduce-scatter of the
            differences, fused eq. (2) on the 1/p center shard, allgather)

Two layouts:

  1-axis    ``p`` is an int, one axis (default "dev"). mpi_sgd: the axis
            is the intra-client communicator. mpi_esgd: each device is one
            client (the axis plays the pod role).
  2-axis    ``p`` is ``(P, D)``: mpi_sgd reduce-scatters over pod then
            data; mpi_esgd confines the gradient leg to 'data' inside each
            pod-client (state sharded 1/D) and the exchange crosses 'pod'
            with α = esgd_alpha / P.

With ``SyncConfig.overlap`` (mpi_sgd) the gradient leg is backward
overlapped: every device runs the staged backward in lockstep
(``launch.train.make_overlap_grad_fn``), each schedule bucket's
(hierarchical) reduce-scatter is issued as soon as its stage's grads
exist, and the optimizer state is laid out bucket-major
(``optstate_sched_init`` at the gradient group's p).

Driver state is *stacked*: every leaf carries a leading device dim
p_total (pod-major for 2-axis), the reference's layout. The reference
maps one per-device program with a named vmap per axis, or runs it under
``shard_map`` on a real mesh; the port has the same two forms of the
same program (``make_device_step``):

  emulated  ``make_emulated_step``: ONE program runs the whole world. The
            stacked state is viewed with the world's shape as its leading
            dims, forward and backward run per device in a loop (one
            device's activations live at a time), and the collectives and
            the elastic kernels run over the stacked buffers — one kernel
            launch for all devices, as one ``pallas_call`` under vmap.
  process   ``make_sharded_step`` over a ``launch.mesh.Mesh``: one process
            per device, each holding its leading-dim-1 block of the
            stacked state (``make_driver_state(mesh=)``, ``rank_block``),
            as ``shard_map`` hands each device its block. The ring hops
            are ``torch.distributed`` messages (``core.comm``'s process
            backend) and each rank launches the kernels on its own shard.
            Both forms give the same bits.

``drive(faults=...)`` injects a deterministic schedule on the 1-axis
layout: ``kill@s:unit=d`` evicts device d before step s (the survivors'
rows carry over, the FlatBuffer optimizer state is re-sharded by
``core.membership.reshard_optstate`` and the step is rebuilt at the new
count), ``restart@s:unit=d`` admits d before step s, ``corrupt`` adds
seeded noise to a device's float batch leaves. Each membership change
logs its byte and time accounting (``core.cost_model``).

Not ported yet: the GSPMD path (``launch/train.make_train_step`` with a
mesh, ``sharding/rules``); faults on a process mesh are refused.

  python -m repro_torch.launch.shard_driver 4 [--device cpu]

runs the selftest: p gloo ranks on the card (or the CPU), both modes and
every optimizer against the single-process train step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.core import comm as comm_lib, cost_model, flatbuf
from repro_torch.core.collectives import WireMeter
from repro_torch.core.comm import Communicator, sync_comms
from repro_torch.core.elastic import elastic_exchange_sharded
from repro_torch.core.faults import FaultInjector, injector
from repro_torch.core.hierarchy import SyncConfig, should_elastic_sync
from repro_torch.core.membership import Membership, reshard_optstate
from repro_torch.core.sync_engine import flat_update_supported, make_sync_engine
from repro_torch.launch.train import (
    grad_spec,
    make_grad_fn,
    make_overlap_grad_fn,
    overlap_schedule,
    resolve_device,
    stacked_grads,
)
from repro_torch.models.model import Model
from repro_torch.optim.sgd import Optimizer, optstate_sched_init, optstate_shard_init
from repro_torch.tree import tree_map

AXIS = "dev"                         # the 1-axis layout's single axis
POD_AXIS, DATA_AXIS = "pod", "data"  # the 2-axis (hierarchy) layout

Geometry = Union[int, Sequence[int]]


def _factorize(p: Geometry, axis_name: str = AXIS
               ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Normalize the device geometry: an int is the 1-axis layout over
    ``axis_name``; a (pods, data) pair is the 2-axis pod×data layout."""
    if isinstance(p, (tuple, list)):
        if len(p) != 2:
            raise ValueError(
                f"2-axis geometry is (pods, data), got {tuple(p)}")
        return (int(p[0]), int(p[1])), (POD_AXIS, DATA_AXIS)
    return (int(p),), (axis_name,)


def driver_world(sync: SyncConfig, p: Geometry, *, axis_name: str = AXIS,
                 meter: Optional[WireMeter] = None, mesh=None) -> Communicator:
    """The top-level communicator for a driver geometry, carrying the
    SyncConfig's collective policy (and ``meter``, counting wire bytes);
    with ``mesh``, over its processes."""
    shape, axes = _factorize(p, axis_name)
    return comm_lib.from_sync(sync, axes, shape, meter=meter, mesh=mesh)


def _require_supported(model: Model, optimizer: Optimizer, sync: SyncConfig,
                       world: Communicator) -> flatbuf.FlatBuffer:
    if not flat_update_supported(optimizer, sync, None):
        raise ValueError(
            "the shard driver runs the flat fused substrate only: "
            "momentum-SGD (f32 state), AdaGrad or AdamW with "
            "SyncConfig.fused_update=True")
    sync.validate()
    if sync.mode == "mpi_esgd":
        _, ex = sync_comms(sync, world)
        pods = ex.static_size
        if sync.num_clients != pods:
            what = ("one client per pod" if POD_AXIS in world.axes
                    else "one client per device")
            raise ValueError(
                f"mpi_esgd under the shard driver maps {what}: "
                f"num_clients={sync.num_clients} != {pods} (world "
                f"axes {world.axes}, sizes {world.sizes})")
    return grad_spec(model)


def shard_batch(batch: Any, p: Geometry) -> Any:
    """(B, ...) host batch -> (p_total, B/p_total, ...) stacked per-device
    shards (pod-major for 2-axis geometries). For mpi_esgd the leading dim
    doubles as the client dim (pod == client)."""
    shape, _ = _factorize(p)
    n = math.prod(shape)
    leaves = list(batch.values())
    if leaves and leaves[0].shape[0] % n:
        raise ValueError(
            f"batch size {leaves[0].shape[0]} does not divide over "
            f"{n} devices (geometry {p})")
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _stack(tree: Any, n: int) -> Any:
    return tree_map(
        lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape)).clone(), tree)


def make_driver_state(model: Model, optimizer: Optimizer, sync: SyncConfig,
                      p: Geometry | None = None, seed: int = 0, *,
                      device="cuda", mesh=None, axis_name: str = AXIS) -> dict:
    """Stacked (leading device dim p_total) initial state.

    mpi_sgd: params replicated, optimizer state sharded 1/p_total per
    device. mpi_esgd: one replica per client, optimizer state sharded over
    the client's gradient group (1-axis: full local state per device;
    2-axis: 1/D per device), replicated center. With overlap the state is
    the bucket-major schedule shard at the gradient group's p.

    With ``mesh`` (the geometry then comes from the mesh, the device is
    the mesh's) only this rank's leading-dim-1 block is built: every
    device's block is the same at init."""
    if mesh is not None:
        p, _ = _mesh_geometry(mesh, axis_name)
        device = mesh.device
    device = resolve_device(device)
    world = driver_world(sync, p)
    spec = _require_supported(model, optimizer, sync, world)
    grad_comm, _ = sync_comms(sync, world)
    n = 1 if mesh is not None else world.static_size
    if sync.overlap:
        _, schedule = overlap_schedule(model, sync, grad_comm.static_size)
        opt0 = optstate_sched_init(optimizer.hyper, schedule, device=device)
    else:
        opt0 = optstate_shard_init(optimizer.hyper, spec,
                                   grad_comm.static_size,
                                   grad_comm.rings_for(spec.nbytes),
                                   device=device)
    params = model.init(device=device, seed=seed)
    state = {
        "params": _stack(params, n),
        "opt": _stack(opt0, n),
        "step": torch.zeros((n,), dtype=torch.int32, device=device),
    }
    if sync.mode == "mpi_esgd":
        state["center"] = _stack(params, n)
    return state


def make_device_step(model: Model, optimizer: Optimizer, sync: SyncConfig,
                     *, world: Communicator, microbatch: int = 1
                     ) -> tuple[Callable, Optional[Callable]]:
    """The programs of the emulated world: ``(device_step,
    device_exchange)``, over state whose leaves carry the world's shape as
    leading dims.

    ``device_step`` computes each device's grads on its batch shard and
    runs the engine's sync+update leg over the gradient communicator (with
    overlap, the staged backward issues the per-bucket legs and the
    engine's ``update_overlapped`` finishes); ``device_exchange``
    (mpi_esgd only) is the sharded elastic exchange over the exchange
    (pod) communicator."""
    grad_comm, ex_comm = sync_comms(sync, world)
    spec = grad_spec(model)
    ndim = len(world.frame)
    stages = schedule = None
    if sync.overlap:
        if microbatch > 1:
            raise ValueError(
                "overlap=True with microbatch>1 would re-issue every "
                "schedule bucket's ring leg per accumulation step (M× "
                "the wire bytes overlap exists to hide); accumulate "
                "without overlap, or raise the per-step batch instead")
        stages, schedule = overlap_schedule(model, sync,
                                            grad_comm.resolve_size())
    engine = make_sync_engine(optimizer, sync, None, comm=grad_comm, spec=spec,
                              schedule=schedule)
    if sync.overlap:
        ograd_fn = make_overlap_grad_fn(model, stages, schedule, grad_comm)
    else:
        grad_fn = make_grad_fn(model, microbatch)

    def device_step(state, batch):
        if sync.overlap:
            loss, metrics, g_shard = ograd_fn(state["params"], batch)
            new_staged, new_o = engine.update_overlapped(
                g_shard, stages.stage(state["params"], ndim), state["opt"])
            del g_shard
            new_p = stages.unstage(new_staged, ndim)
        else:
            loss, metrics, grads = stacked_grads(grad_fn, state["params"],
                                                 batch, ndim)
            new_p, new_o = engine.update(grads, state["opt"], state["params"])
            del grads
        metrics = {k: world.pmean(v) for k, v in
                   {"loss": loss, **metrics}.items()}
        return dict(state, params=new_p, opt=new_o,
                    step=state["step"] + 1), metrics

    if ex_comm is None:
        return device_step, None

    def device_exchange(state):
        alpha = sync.esgd_alpha / ex_comm.resolve_size()
        new_p, new_c = elastic_exchange_sharded(
            spec, state["params"], state["center"], alpha, comm=ex_comm)
        return dict(state, params=new_p, center=new_c)

    return device_step, device_exchange


def _compose(mapped_step: Callable, mapped_exchange: Optional[Callable],
             sync: SyncConfig) -> Callable:
    """Full driver step over stacked state: the update, then — on the
    INTERVAL boundary of the pre-update step count — the elastic
    exchange (launch/train.py's step_multiclient order)."""

    def step(state, batch):
        old_step = state["step"].reshape(-1)[0]
        new_state, metrics = mapped_step(state, batch)
        if mapped_exchange is not None and bool(
                should_elastic_sync(old_step, sync.esgd_interval)):
            new_state = mapped_exchange(new_state)
        # pmean'd over the world: identical on every device — report one
        return new_state, {k: m.reshape(-1)[0] for k, m in metrics.items()}

    return step


def _on_world(fn: Callable, shape: tuple[int, ...]) -> Callable:
    """View the stacked (p_total-leading) arguments with the world's
    shape as leading dims, run ``fn``, and flatten its results back."""
    n = math.prod(shape)

    def split(t):
        return t.reshape(shape + tuple(t.shape[1:]))

    def merge(t):
        return t.reshape((n,) + tuple(t.shape[len(shape):]))

    def g(*args):
        return tree_map(merge, fn(*tree_map(split, args)))

    return g


def make_emulated_step(model: Model, optimizer: Optimizer, sync: SyncConfig,
                       p: Geometry, *, axis_name: str = AXIS,
                       microbatch: int = 1,
                       meter: Optional[WireMeter] = None) -> Callable:
    """The emulated driver step ``step(state, batch) -> (state, metrics)``
    over stacked state and ``shard_batch`` batches; ``meter`` counts the
    bytes one device puts on the wire."""
    shape, _ = _factorize(p, axis_name)
    world = driver_world(sync, p, axis_name=axis_name, meter=meter)
    _require_supported(model, optimizer, sync, world)
    dev_step, dev_ex = make_device_step(model, optimizer, sync, world=world,
                                        microbatch=microbatch)
    step = _compose(_on_world(dev_step, shape),
                    _on_world(dev_ex, shape) if dev_ex else None, sync)

    def emulated_step(state, batch):
        device = state["step"].device
        return step(state, {k: v.to(device) for k, v in batch.items()})

    return emulated_step


def _mesh_geometry(mesh, axis_name: str = AXIS
                   ) -> tuple[Geometry, tuple[str, ...]]:
    """Which driver layout a mesh carries: ('pod' and 'data') -> 2-axis,
    else the single ``axis_name`` axis."""
    if POD_AXIS in mesh.shape and DATA_AXIS in mesh.shape:
        return ((mesh.shape[POD_AXIS], mesh.shape[DATA_AXIS]),
                (POD_AXIS, DATA_AXIS))
    if axis_name not in mesh.shape:
        raise ValueError(
            f"mesh axes {dict(mesh.shape)} fit neither driver layout: "
            f"expected a '{axis_name}' axis (1-axis) or both "
            f"'{POD_AXIS}' and '{DATA_AXIS}' axes (2-axis hierarchy)")
    return mesh.shape[axis_name], (axis_name,)


def rank_block(tree: Any, mesh) -> Any:
    """This rank's leading-dim-1 block of a stacked (p_total-leading)
    tree: a ``make_driver_state`` state or a ``shard_batch`` batch."""
    i = mesh.index
    return tree_map(lambda t: t[i:i + 1], tree)


def gather_blocks(blocks: Sequence[Any]) -> Any:
    """The stacked tree from every rank's block, in rank order (the
    inverse of ``rank_block``)."""
    return tree_map(lambda *ts: torch.cat(ts), *blocks)


def make_sharded_step(model: Model, optimizer: Optimizer, sync: SyncConfig,
                      mesh, *, axis_name: str = AXIS, microbatch: int = 1,
                      meter: Optional[WireMeter] = None) -> Callable:
    """The driver step of one rank of a process mesh: ``step(block,
    batch_block) -> (block, metrics)`` over this rank's leading-dim-1
    blocks of the driver state and of ``shard_batch`` (``rank_block``),
    the ring collectives crossing ``mesh``'s processes. A mesh with 'pod'
    and 'data' axes selects the 2-axis hierarchy layout. The metrics are
    the same on every rank; ``meter`` counts the bytes this rank puts on
    the wire."""
    p, _ = _mesh_geometry(mesh, axis_name)
    world = driver_world(sync, p, axis_name=axis_name, meter=meter,
                         mesh=mesh)
    _require_supported(model, optimizer, sync, world)
    dev_step, dev_ex = make_device_step(model, optimizer, sync, world=world,
                                        microbatch=microbatch)
    block = (1,) * len(world.frame)
    step = _compose(_on_world(dev_step, block),
                    _on_world(dev_ex, block) if dev_ex else None, sync)

    def sharded_step(state, batch):
        return step(state, {k: v.to(mesh.device) for k, v in batch.items()})

    return sharded_step


def _check_driver_faults(inj: FaultInjector, p: Geometry) -> None:
    """What the driver's fault path serves: kill and restart (membership
    reconfiguration) and corrupt (seeded batch noise), on the emulated
    1-axis layout. Timing faults need a clock."""
    timed = inj.schedule.kinds & {"drop", "delay", "straggle"}
    if timed:
        raise ValueError(
            f"fault kinds {sorted(timed)} need a clock — the driver's step "
            "has no timing axis; run them through the event-driven "
            "simulation (core/algorithms.py, AlgoConfig.faults). The driver "
            "serves kill/corrupt.")
    shape, _ = _factorize(p)
    if inj.schedule.kinds & {"kill", "restart"} and len(shape) == 2:
        # pod kills/joins need the hierarchical (pod-then-data) shard
        # layout re-derived, which only the 1-axis ring-major geometry
        # shares with membership.reshard_optstate
        raise ValueError(
            "kill/restart faults under the 2-axis pod×data layout are not "
            "wired — the hierarchical state re-layout is not implemented; "
            "use the 1-axis layout")


def _reconfigure(model: Model, optimizer: Optimizer, sync: SyncConfig,
                 state: dict, p_old: int, dead: list[int], live: Membership,
                 *, axis_name: str, microbatch: int
                 ) -> tuple[dict, int, Callable, dict]:
    """Evict ``dead`` devices from a 1-axis emulated run: re-split the
    geometry to the survivor count, carry the survivors' rows of the
    stacked state over, re-shard the FlatBuffer optimizer state
    (``reshard_optstate``: survivors keep their slices, dead slices
    restart from zero), and rebuild the step.

    mpi_sgd: the axis is ONE data-parallel group — params are replicated
    and optimizer state is 1/p sharded, so it is re-laid-out p_old ->
    p_new. mpi_esgd: each device is one client with full local state —
    the dead client's row is dropped and the SyncConfig shrinks to the
    survivor client count."""
    for u in dead:
        live.fail(u)
    survivors = [r for r in range(p_old) if live.is_live(r)]
    p_new = len(survivors)
    rows = torch.tensor(survivors, device=state["step"].device)
    world = driver_world(sync, p_old, axis_name=axis_name)
    info: dict = {"p_old": p_old, "p_new": p_new, "moved_bytes": 0.0,
                  "survivors": tuple(survivors)}
    if sync.mode == "mpi_esgd":
        sync = dataclasses.replace(sync, num_clients=p_new)
        state = tree_map(lambda l: l[rows], state)
    else:
        new_opt, rinfo = reshard_optstate(
            optimizer.hyper, grad_spec(model), state["opt"], p_old, p_new,
            survivors=survivors, num_rings=world.policy.num_rings,
            bucket_bytes=world.policy.bucket_bytes)
        info.update(rinfo)
        state = {**tree_map(lambda l: l[rows],
                            {k: v for k, v in state.items() if k != "opt"}),
                 "opt": new_opt}
    step = make_emulated_step(model, optimizer, sync, p_new,
                              axis_name=axis_name, microbatch=microbatch)
    return state, p_new, step, dict(info, sync=sync)


def _rejoin(model: Model, optimizer: Optimizer, sync: SyncConfig,
            state: dict, p_old: int, joiners: list[int], live: Membership,
            *, axis_name: str, microbatch: int
            ) -> tuple[dict, int, Callable, dict]:
    """Admit ``joiners`` into a 1-axis emulated run: a new membership
    epoch per joiner, the geometry re-split to the grown count, the
    FlatBuffer optimizer state re-sharded at p_new (``reshard_optstate``
    with every old shard surviving), and the step rebuilt.

    mpi_sgd: params are replicated, so the joiner's row is a copy of row
    0 — the emulated form of a respawned worker pulling the live params.
    mpi_esgd: the joiner is a NEW client admitted at the current center
    with fresh local optimizer state, and the SyncConfig grows."""
    old_ids = list(live.live)
    for u in joiners:
        live.join(u)
    new_ids = list(live.live)
    p_new = len(new_ids)
    pos = {u: r for r, u in enumerate(old_ids)}
    rows = [pos.get(u, -1) for u in new_ids]
    world = driver_world(sync, p_old, axis_name=axis_name)
    info: dict = {"p_old": p_old, "p_new": p_new, "moved_bytes": 0.0,
                  "joined": tuple(joiners), "survivors": tuple(range(p_old))}

    def expand(tree, fill):
        return tree_map(lambda l: torch.stack(
            [l[r] if r >= 0 else fill(l) for r in rows]), tree)

    if sync.mode == "mpi_esgd":
        sync = dataclasses.replace(sync, num_clients=p_new)
        state = {
            "params": tree_map(
                lambda pl, cl: torch.stack(
                    [pl[r] if r >= 0 else cl[0] for r in rows]),
                state["params"], state["center"]),
            "opt": expand(state["opt"], lambda l: torch.zeros_like(l[0])),
            "step": expand(state["step"], lambda l: l[0]),
            "center": expand(state["center"], lambda l: l[0]),
        }
    else:
        new_opt, rinfo = reshard_optstate(
            optimizer.hyper, grad_spec(model), state["opt"], p_old, p_new,
            survivors=list(range(p_old)), num_rings=world.policy.num_rings,
            bucket_bytes=world.policy.bucket_bytes)
        info.update(rinfo)
        rest = {k: v for k, v in state.items() if k != "opt"}
        state = {**{k: expand(v, lambda l: l[0]) for k, v in rest.items()},
                 "opt": new_opt}
    step = make_emulated_step(model, optimizer, sync, p_new,
                              axis_name=axis_name, microbatch=microbatch)
    return state, p_new, step, dict(info, sync=sync)


def _corrupt_rows(inj: FaultInjector, shard: dict, live: Membership,
                  i: int) -> dict:
    """Each live device's batch shard with its scheduled corruption at
    step ``i`` (seeded noise on float leaves; token ids are left alone).
    The caller's batch is never written."""
    out = dict(shard)
    for r, u in enumerate(live.live):
        if not inj.active(u, i):
            continue
        row = {k: v[r] for k, v in out.items()}
        for k, v in inj.corrupt(row, u, i).items():
            if v is not row[k]:
                out[k] = out[k].clone()
                out[k][r] = v
    return out


def drive(model: Model, optimizer: Optimizer, sync: SyncConfig, batches, *,
          p: Geometry | None = None, mesh=None, axis_name: str = AXIS,
          seed: int = 0, device="cuda", microbatch: int = 1,
          log_every: int = 10, callback: Optional[Callable] = None,
          faults=None, fault_seed: int = 0,
          net: Optional[cost_model.NetParams] = None) -> tuple[dict, list]:
    """Training loop over the shard driver: ``batches`` yield host-layout
    (B, ...) batches, split into per-device shards here.

    ``mesh=None`` emulates ``p`` devices in this process (an int, or a
    (pods, data) pair for the 2-axis hierarchy); with a
    ``launch.mesh.Mesh`` the geometry comes from the mesh axes, this
    process runs its rank (every rank calls ``drive`` with the same
    batches and takes its own shard) and the returned state is its
    block.

    ``faults`` (a ``core.faults`` schedule or its string) injects
    deterministic failures on the 1-axis layout: ``kill@s:unit=d`` evicts
    device d before step s — the run reconfigures to the survivors and a
    ``reconfigure`` entry with the recovery byte/time accounting
    (``cost_model.reconfig_time`` over ``net``, default the paper's
    testbed) lands in the history; ``restart@s:unit=d`` ADMITS device d
    before step s when it is not live (a new id grows the run, a killed
    id rejoins) and logs a ``join`` entry with
    ``cost_model.join_reshard_bytes`` and ``recovery_time``. Kills are
    generation-indexed: a rejoined unit dies again only at its NEXT kill
    event. ``corrupt`` adds seeded noise to the device's float batch
    leaves. Feed batches sized for every geometry the schedule reaches."""
    inj = injector(faults, seed=fault_seed)
    if inj is not None:
        if sync.overlap:
            raise ValueError(
                "drive(faults=...) with SyncConfig.overlap=True is not "
                "wired: the elastic re-layout (membership.reshard_optstate) "
                "assumes the monolithic ring-major shard geometry, not the "
                "bucket-major overlapped schedule — run faults without "
                "overlap, or overlap without faults")
        if mesh is not None:
            raise ValueError(
                "drive(faults=...) runs under vmap emulation only: elastic "
                "reconfiguration on a REAL mesh needs the multi-process "
                "transport (see ROADMAP.md 'real multi-process transport') "
                "— pass p= instead of mesh=")
    if mesh is not None:
        p, _ = _mesh_geometry(mesh, axis_name)
    if p is None:
        raise ValueError("pass p= (emulation) or mesh=")
    if inj is not None:
        _check_driver_faults(inj, p)
    if mesh is None:
        state = make_driver_state(model, optimizer, sync, p, seed,
                                  device=device)
        step = make_emulated_step(model, optimizer, sync, p,
                                  axis_name=axis_name, microbatch=microbatch)
    else:
        state = make_driver_state(model, optimizer, sync, seed=seed,
                                  mesh=mesh, axis_name=axis_name)
        sharded = make_sharded_step(model, optimizer, sync, mesh,
                                    axis_name=axis_name,
                                    microbatch=microbatch)
        step = lambda st, shard: sharded(st, rank_block(shard, mesh))
    live = Membership(math.prod(_factorize(p)[0])) if inj is not None else None
    attempts: dict[int, int] = {}    # unit -> spawn generation
    netp = net or cost_model.testbed()
    history = []

    def log(entry):
        history.append(entry)
        if callback:
            callback(entry)

    for i, batch in enumerate(batches):
        if inj is not None:
            joiners = [u for u in inj.restart_units(i) if not live.is_live(u)]
            if joiners:
                delay = max(inj.restart_delay(u, attempts.get(u, 0)) or 0.0
                            for u in joiners)
                for u in joiners:
                    attempts[u] = attempts.get(u, 0) + 1
                state, p, step, info = _rejoin(
                    model, optimizer, sync, state, int(p), joiners, live,
                    axis_name=axis_name, microbatch=microbatch)
                sync = info.pop("sync")
                state_nbytes = info.get("state_nbytes", 0.0)
                log({"step": i, "event": "join", **info,
                     "join_reshard_bytes": cost_model.join_reshard_bytes(
                         state_nbytes, info["p_old"]),
                     "recovery_time": cost_model.recovery_time(
                         0.0, delay, info["p_old"], info["p_new"], netp,
                         state_nbytes=state_nbytes)})
            dead = [u for u in live.live
                    if inj.is_killed(u, i, attempts.get(u, 0))]
            if dead:
                if len(dead) >= live.live_count:
                    raise ValueError(
                        f"fault schedule kills every live device at step "
                        f"{i} — no survivor group to reconfigure to")
                state, p, step, info = _reconfigure(
                    model, optimizer, sync, state, int(p), dead, live,
                    axis_name=axis_name, microbatch=microbatch)
                sync = info.pop("sync")
                log({"step": i, "event": "reconfigure", "killed": dead, **info,
                     "reconfig_time": cost_model.reconfig_time(
                         info.get("state_nbytes", 0.0), info["p_old"],
                         info["p_new"], netp,
                         survivors=len(info["survivors"]))})
        shard = shard_batch(batch, p)
        if inj is not None:
            shard = _corrupt_rows(inj, shard, live, i)
        state, metrics = step(state, shard)
        if i % log_every == 0:
            entry = {k: float(v) for k, v in metrics.items()}
            entry["step"] = i
            log(entry)
    return state, history


def _selftest_rank(mesh, batch) -> dict:
    """One rank of ``_selftest``: both modes and every optimizer family
    (the 2-axis meshes: momentum SGD) through ``drive(mesh=)``, 3 steps;
    returns the losses by case."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import build_model
    from repro_torch.optim.sgd import adagrad, adamw, sgd

    model = build_model(reduced(get_config("qwen2-0.5b")))
    p, _ = _mesh_geometry(mesh)
    pods = p[0] if isinstance(p, tuple) else p
    opts = ((sgd(0.1, momentum=0.9), adamw(3e-3), adagrad(0.05))
            if not isinstance(p, tuple) else (sgd(0.1, momentum=0.9),))
    out = {}
    for opt in opts:
        for sync in (SyncConfig(mode="mpi_sgd", num_clients=1),
                     SyncConfig(mode="mpi_esgd", num_clients=pods,
                                esgd_interval=2)):
            _, hist = drive(model, opt, sync, [batch] * 3, mesh=mesh,
                            seed=1, log_every=1)
            out[(opt.hyper["name"], sync.mode)] = [h["loss"] for h in hist]
    return out


def _selftest(p: int = 8, device="cuda") -> None:  # pragma: no cover
    """The process mesh: p gloo ranks on ``device``, one process each, run
    ``drive(mesh=)`` for both modes and every optimizer family; the losses
    must match the single-process train step (``launch.train.
    make_train_step``) on ``device`` within rtol 1e-4. Then the 2-axis
    pod×data hierarchy (both factorizations of p) with momentum SGD."""
    import numpy as np

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.sgd import get_optimizer

    torch.set_num_threads(1)
    model = build_model(reduced(get_config("qwen2-0.5b")))
    toks = torch.randint(0, 1024, (p, 32),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    hyper = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=3e-3),
             "adagrad": dict(lr=0.05)}
    layouts = [((p,), (AXIS,))]
    for pd in ((2, p // 2), (p // 2, 2)):
        if ((pd, (POD_AXIS, DATA_AXIS))) not in layouts:
            layouts.append((pd, (POD_AXIS, DATA_AXIS)))
    for shape, axes in layouts:
        got = spawn_ranks(_selftest_rank, shape, axes, backend="gloo",
                          device=device, args=(batch,))
        pods = shape[0]
        for (oname, mode), losses in got[0].items():
            if any(g[(oname, mode)] != losses for g in got[1:]):
                raise AssertionError(f"ranks disagree on {oname} {mode}")
            opt = get_optimizer(oname, **hyper[oname])
            sync = SyncConfig(mode=mode, num_clients=1 if mode == "mpi_sgd"
                              else pods, esgd_interval=2)
            ref = make_train_state(model, opt, sync, 1, device=device)
            ref_step = make_train_step(model, opt, sync, device=device)
            ref_batch = (batch if sync.num_clients <= 1
                         else shard_batch(batch, pods))
            want = []
            for _ in range(3):
                ref, mr = ref_step(ref, ref_batch)
                want.append(float(mr["loss"]))
            np.testing.assert_allclose(losses, want, rtol=1e-4)
            print(f"shard driver selftest OK mesh={shape} mode={mode} "
                  f"opt={oname} (process mesh on {math.prod(shape)} ranks, "
                  f"backend gloo, {device})")


if __name__ == "__main__":  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser(
        description="the shard driver over p gloo ranks against the "
                    "single-process train step")
    ap.add_argument("p", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    _selftest(args.p, args.device)
