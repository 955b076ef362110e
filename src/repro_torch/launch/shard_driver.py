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

Driver state is *stacked*: every leaf carries a leading device dim
p_total (pod-major for 2-axis), the reference's layout. The reference
maps a per-device program with one named vmap per axis; here ONE program
runs the emulated world (``make_emulated_step``): the stacked state is
viewed with the world's shape as its leading dims, forward and backward
run per device in a loop (one device's activations live at a time), and
the collectives and the elastic kernels run over the stacked buffers —
one kernel launch for all devices, as one ``pallas_call`` under vmap.

Not ported yet: ``make_sharded_step`` (a real multi-GPU backend over
``torch.distributed``, P2P send/recv for the int8 hops) and ``drive``'s
faults and joins (elastic membership); both raise.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.core import comm as comm_lib, flatbuf
from repro_torch.core.collectives import WireMeter
from repro_torch.core.comm import Communicator, sync_comms
from repro_torch.core.elastic import elastic_exchange_sharded
from repro_torch.core.hierarchy import SyncConfig, should_elastic_sync
from repro_torch.core.sync_engine import flat_update_supported, make_sync_engine
from repro_torch.launch.train import (
    grad_spec,
    make_grad_fn,
    resolve_device,
    stacked_grads,
)
from repro_torch.models.model import Model
from repro_torch.optim.sgd import Optimizer, optstate_shard_init
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
                 meter: Optional[WireMeter] = None) -> Communicator:
    """The top-level communicator for a driver geometry, carrying the
    SyncConfig's collective policy (and ``meter``, counting wire bytes)."""
    shape, axes = _factorize(p, axis_name)
    return comm_lib.from_sync(sync, axes, shape, meter=meter)


def _require_supported(model: Model, optimizer: Optimizer, sync: SyncConfig,
                       world: Communicator) -> flatbuf.FlatBuffer:
    if not flat_update_supported(optimizer, sync, None):
        raise ValueError(
            "the shard driver runs the flat fused substrate only: "
            "momentum-SGD (f32 state), AdaGrad or AdamW with "
            "SyncConfig.fused_update=True")
    sync.validate()
    if sync.overlap:
        raise NotImplementedError(
            "not yet ported: backward overlap (SyncConfig.overlap) under "
            "the shard driver")
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
                      p: Geometry, seed: int = 0, *, device="cuda") -> dict:
    """Stacked (leading device dim p_total) initial state.

    mpi_sgd: params replicated, optimizer state sharded 1/p_total per
    device. mpi_esgd: one replica per client, optimizer state sharded over
    the client's gradient group (1-axis: full local state per device;
    2-axis: 1/D per device), replicated center."""
    device = resolve_device(device)
    world = driver_world(sync, p)
    spec = _require_supported(model, optimizer, sync, world)
    grad_comm, _ = sync_comms(sync, world)
    n = world.static_size
    opt0 = optstate_shard_init(optimizer.hyper, spec, grad_comm.static_size,
                               grad_comm.rings_for(spec.nbytes), device=device)
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
    runs the engine's sync+update leg over the gradient communicator;
    ``device_exchange`` (mpi_esgd only) is the sharded elastic exchange
    over the exchange (pod) communicator."""
    grad_comm, ex_comm = sync_comms(sync, world)
    spec = grad_spec(model)
    engine = make_sync_engine(optimizer, sync, None, comm=grad_comm, spec=spec)
    grad_fn = make_grad_fn(model, microbatch)
    ndim = len(world.frame)

    def device_step(state, batch):
        loss, metrics, grads = stacked_grads(grad_fn, state["params"], batch,
                                             ndim)
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


def make_sharded_step(model: Model, optimizer: Optimizer, sync: SyncConfig,
                      mesh, **kw) -> Callable:
    """The real multi-device driver: not ported yet."""
    raise NotImplementedError(
        "not yet ported: make_sharded_step needs a real multi-GPU backend "
        "(torch.distributed across cards, P2P send/recv for the int8 "
        "hops), queued in ROADMAP; make_emulated_step runs the same "
        "program on one card")


def drive(model: Model, optimizer: Optimizer, sync: SyncConfig, batches, *,
          p: Geometry | None = None, mesh=None, axis_name: str = AXIS,
          seed: int = 0, device="cuda", microbatch: int = 1,
          log_every: int = 10, callback: Optional[Callable] = None,
          faults=None) -> tuple[dict, list]:
    """Training loop over the emulated shard driver: ``batches`` yield
    host-layout (B, ...) batches, split into per-device shards here."""
    if mesh is not None:
        raise NotImplementedError(
            "not yet ported: drive(mesh=...) needs make_sharded_step; pass "
            "p= to emulate the devices")
    if faults is not None:
        raise NotImplementedError(
            "not yet ported: drive(faults=...) kills and joins belong to "
            "the elastic membership slice")
    if p is None:
        raise ValueError("pass p= (the emulated device geometry)")
    state = make_driver_state(model, optimizer, sync, p, seed, device=device)
    step = make_emulated_step(model, optimizer, sync, p, axis_name=axis_name,
                              microbatch=microbatch)
    history = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, shard_batch(batch, p))
        if i % log_every == 0:
            entry = {k: float(v) for k, v in metrics.items()}
            entry["step"] = i
            history.append(entry)
            if callback:
                callback(entry)
    return state, history
