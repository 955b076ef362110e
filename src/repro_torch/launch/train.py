"""Production train step + training-loop driver (``repro/launch/train.py``).

``make_train_step`` builds the step for both lowerable sync modes:

  mpi_sgd   C = 1 (``step_c1``): gradients of the model's loss, then the
            ``SyncEngine``'s update leg — on the default path the
            FlatEngine packs the gradient pytree into the persistent f32
            ``FlatBuffer``, runs ONE fused optimizer kernel over it, and
            unpacks the updated params (bf16 params are rounded back every
            step; there is no f32 master copy)
  mpi_esgd  C > 1 (``step_multiclient``): params carry a leading client
            dim; each client's grads come from its own batch slice, the
            update runs for every client at once (one kernel launch over
            the stacked buffer, each client in local p = 1 geometry), and
            every INTERVAL steps the elastic exchange (eqs. 2/3, one fused
            kernel) pulls the replicas and the center together

With a ``mesh`` (a ``launch.mesh.Mesh``: one process per device) the step
is the reference's GSPMD path on ``torch.distributed.tensor``:
``make_train_state(..., mesh=)`` lays the state out as DTensors by
``state_specs`` (``sharding.param_specs``: tensor parallelism on heads /
ff / vocab over 'model', FSDP over 'data' with ``SyncConfig.fsdp``), the
batch is sharded over ('pod', 'data'), the updates are per-leaf, and
DTensor's redistributes are every collective: the model's tensor-parallel
all-reduces, each gradient's ``Partial`` -> its param's placements (the
data-axis all-reduce; a reduce-scatter under FSDP), and for C > 1 the
elastic exchange across 'pod'. No hand kernel runs on this path.

With ``SyncConfig.overlap`` (mpi_sgd, C = 1) the step is the reference's
``step_overlap``: ``make_overlap_grad_fn`` runs the forward stage by
stage (``Model.overlap_stages``), then the backward head first, one
``torch.autograd.grad`` per stage, and issues each schedule bucket's
reduce-scatter leg as soon as its stage's grads exist; the engine's
``update_overlapped`` runs the fused kernel ONCE over the bucket-major
shard and the one trailing allgather.

Entry points default to the CUDA device and raise when there is none,
unless the caller passes ``device="cpu"``. The CLI takes the reference
worker's flags and lowers them as it does (``settings_from_args``):

  python -m repro_torch.launch.train --full-size --steps 5
  python -m repro_torch.launch.train --device cpu --steps 3 --wire-dtype int8 --allreduce ring
  python -m repro_torch.launch.train --device cpu --steps 3 --policy auto
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
import types
from typing import Any, Callable, Optional

import torch

from repro_torch.core import comm as comm_lib, flatbuf
from repro_torch.core.hierarchy import (
    SyncConfig,
    clientize,
    clientize_specs,
    should_elastic_sync,
)
from repro_torch.core.sync_engine import (
    flat_exchange_active,
    flat_update_supported,
    make_sync_engine,
)
from repro_torch.models.model import Model
from repro_torch.optim.sgd import Optimizer
from repro_torch.sharding.rules import P, batch_pspec, distribute, param_specs, shard_batch_dim
from repro_torch.tree import TreeDef, tree_flatten, tree_leaves, tree_map, tree_unflatten


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA request with no CUDA
    device raises (pass ``device="cpu"`` to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return device


def fused_path_active(optimizer: Optimizer, sync: SyncConfig,
                      mesh=None) -> bool:
    """Whether the flat fused update replaces the per-leaf update
    (``core.sync_engine.flat_update_supported``); make_train_state and
    make_train_step must agree, so both ask with the same mesh."""
    return flat_update_supported(optimizer, sync, mesh)


def grad_spec(model: Model) -> flatbuf.FlatBuffer:
    """The persistent FlatBuffer spec of this model's gradient pytree,
    built once from shape-only (``meta``) params."""
    return flatbuf.spec_for(model.init(device="meta"))


def _engine_spec(model: Model, optimizer: Optimizer, sync: SyncConfig,
                 mesh=None):
    """The FlatBuffer spec, when any flat leg will engage (else None)."""
    if (flat_update_supported(optimizer, sync, mesh)
            or flat_exchange_active(sync, mesh)):
        return grad_spec(model)
    return None


def overlap_schedule(model: Model, sync: SyncConfig, p: int = 1):
    """(OverlapStages, BucketSchedule) for the backward-overlapped path.

    The schedule is built once over the STAGED param spec — the
    FlatBuffer of ``stage(params)``'s stage-subtree tuple, whose leaf
    order (tuple order, sorted keys inside each dict) groups each
    backward stage's params contiguously, so every schedule bucket is a
    leaf-boundary slice. ``p`` is the gradient group's shard count (1 for
    the local state geometry)."""
    if model.overlap_stages is None:
        raise ValueError(
            f"SyncConfig.overlap=True but model {model.cfg.name!r} does "
            "not publish overlap_stages — the staged-backward hook is "
            "wired for the decoder family (models/model.py "
            "_decoder_overlap_stages); run this architecture without "
            "overlap")
    stages = model.overlap_stages(sync.overlap_buckets)
    staged = stages.stage(model.init(device="meta"))
    spec = flatbuf.spec_for(staged)
    counts = tuple(len(tree_leaves(s)) for s in staged)
    return stages, flatbuf.bucket_schedule(spec, counts, p)


def stage_backward(s: int, outputs: list, inputs: list,
                   cotangents: list) -> tuple:
    """Stage ``s``'s backward for every member of the emulated world at
    once: the grads of ``inputs`` (the stage's params and incoming carry)
    given the ``cotangents`` of its ``outputs`` (the loss at the head)."""
    return torch.autograd.grad(outputs, inputs, cotangents,
                               materialize_grads=True)


def _fresh_leaf(t: torch.Tensor) -> torch.Tensor:
    """A stage input as a leaf of its own graph (values shared, no copy)."""
    return t.detach().requires_grad_(True) if t.requires_grad else t


def make_overlap_grad_fn(model: Model, stages, schedule,
                         comm: comm_lib.Communicator) -> Callable:
    """``(params, batch) -> (loss, metrics, g_shard)`` with the wire leg
    issued DURING backward.

    The params and batch carry the gradient group's frame (its world's
    device dims) as leading dims; every emulated device runs the staged
    backward in lockstep, as the reference's vmap does. Forward runs
    stage by stage for every device, each stage's params and incoming
    carry made fresh leaves of that stage's graph; backward then runs
    head first, one ``stage_backward`` per stage over all devices, and
    bucket ``s``'s ring reduce-scatter is issued right after stage
    ``s``'s backward, before stage ``s-1``'s. ``g_shard`` is each
    device's bucket-major ``(…, schedule.shard_size)`` concat of its
    reduced chunks — feed it to ``FlatEngine.update_overlapped``. All
    devices' activations stay live until their stage's backward."""
    S = stages.num_stages
    ndim = len(comm.frame)

    def grad_fn(params, batch):
        lead = tuple(tree_leaves(params)[0].shape[:ndim])
        n = math.prod(lead)
        rows = lambda t: t.reshape((n,) + tuple(t.shape[ndim:]))
        p_rows = tree_map(rows, params)
        b_rows = {k: rows(v) for k, v in batch.items()}
        parts = [stages.stage(tree_map(lambda t: t[m], p_rows))
                 for m in range(n)]
        # forward: record each stage's (param leaves, carry in, output)
        # for every member
        recs = [[None] * n for _ in range(S)]
        for m in range(n):
            bm = {k: v[m] for k, v in b_rows.items()}
            carry = None
            for s in range(S):
                leaves, treedef = tree_flatten(parts[m][s])
                leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
                ps = tree_unflatten(treedef, leaves)
                if s == 0:
                    cin, out = {}, stages.fns[0](ps, bm)
                else:
                    cin = {k: _fresh_leaf(v) for k, v in carry.items()}
                    out = stages.fns[s](ps, cin, bm)
                recs[s][m] = (leaves, cin, out)
                carry = out
        del parts
        losses = [recs[S - 1][m][2][0].detach() for m in range(n)]
        metrics = {k: torch.stack([recs[S - 1][m][2][1][k].detach()
                                   for m in range(n)]).reshape(lead)
                   for k in recs[S - 1][0][2][1]}
        # backward: head first, embedding last; each bucket's
        # reduce-scatter issued as soon as its grads exist
        cts: list = [None] * n
        shards = [None] * S
        for s in range(S - 1, -1, -1):
            outputs, cots, inputs = [], [], []
            for m in range(n):
                leaves, cin, out = recs[s][m]
                if s == S - 1:
                    outputs.append(out[0])
                    cots.append(torch.ones_like(out[0]))
                else:
                    for k, v in out.items():
                        if v.requires_grad:
                            outputs.append(v)
                            cots.append(cts[m][k])
                inputs += leaves + [v for v in cin.values() if v.requires_grad]
            grads = stage_backward(s, outputs, inputs, cots)
            rows_s, i = [], 0
            for m in range(n):
                leaves, cin, _ = recs[s][m]
                rows_s.append(schedule.pack_bucket(s, list(grads[i:i + len(leaves)])))
                i += len(leaves)
                cts[m] = {}
                for k, v in cin.items():
                    if v.requires_grad:
                        cts[m][k] = grads[i]
                        i += 1
            recs[s] = None
            del grads, outputs, cots, inputs
            seg = torch.stack(rows_s).reshape(lead + (schedule.sizes[s],))
            del rows_s
            shards[s] = comm.reduce_scatter_bucket(seg, schedule, s)
        g_shard = shards[0] if S == 1 else torch.cat(shards, -1)
        return torch.stack(losses).reshape(lead), metrics, g_shard

    return grad_fn


def _mesh_device(device, mesh) -> torch.device:
    """The device an entry point runs on; with a mesh, this rank's device,
    which the requested one must name."""
    device = resolve_device(device)
    if mesh is None:
        return device
    if device.type != mesh.device.type:
        raise ValueError(f"device={str(device)!r} but the mesh's ranks hold "
                         f"{mesh.device}; pass device={mesh.device.type!r}")
    return mesh.device


def make_train_state(model: Model, optimizer: Optimizer, sync: SyncConfig,
                     seed: int = 0, *, device="cuda", mesh=None) -> dict:
    """Initial state ``{"params", "opt", "step"}`` (+ ``"center"``, the
    center variables w̃, for mpi_esgd). On the fused path the optimizer
    state is the flat state buffer (momentum / AdaGrad accumulator /
    AdamW ``{"mv", "t"}``) in local (p=1) geometry — one per client when
    C > 1; with overlap, laid out bucket-major over the local schedule.

    With a ``mesh`` the optimizer state is per-leaf and the whole state is
    laid out as DTensors by ``state_specs`` (``sharding.distribute``):
    every rank builds the same state from ``seed`` and keeps its shards."""
    device = _mesh_device(device, mesh)
    schedule = None
    if sync.overlap:
        _, schedule = overlap_schedule(model, sync, 1)
    engine = make_sync_engine(optimizer, sync, mesh,
                              spec=_engine_spec(model, optimizer, sync, mesh),
                              schedule=schedule)
    params = model.init(device=device, seed=seed)
    state = {
        "params": clientize(params, sync.num_clients),
        "opt": clientize(engine.init_opt(params), sync.num_clients),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if sync.mode == "mpi_esgd":
        state["center"] = params
    if mesh is not None:
        state = distribute(state, state_specs(state, mesh, sync), mesh)
    return state


def state_specs(state: Any, mesh, sync: SyncConfig) -> Any:
    """``sharding.P`` specs for a TrainState (the params' rules + the
    client dim on 'pod'). Optimizer state that mirrors the param tree
    (per-leaf momentum, AdaGrad's accumulator) shares the param specs;
    anything else (AdamW's ``{"m", "v", "t"}``, flat buffers) is
    replicated."""
    C = sync.num_clients
    base_params = state["params"]
    if C > 1:
        base_params = tree_map(
            lambda leaf: types.SimpleNamespace(shape=tuple(leaf.shape[1:])),
            base_params)
    pspecs = param_specs(base_params, mesh, fsdp=sync.fsdp)
    out = {
        "params": clientize_specs(pspecs, C),
        "opt": clientize_specs(pspecs, C)
        if _opt_matches(state["opt"], base_params)
        else tree_map(lambda _: P(), state["opt"]),
        "step": P(),
    }
    if "center" in state:
        out["center"] = pspecs
    return out


def _opt_matches(opt_state: Any, params: Any) -> bool:
    """Whether ``opt_state``'s tree is a prefix of ``params``' — where the
    reference's ``jax.tree.map(lambda a, b: None, opt_state, params)``
    succeeds."""
    return _is_prefix(tree_flatten(opt_state)[1], tree_flatten(params)[1])


def _is_prefix(a: TreeDef, b: TreeDef) -> bool:
    if a.kind == "leaf":
        return True
    return (a.kind == b.kind and a.keys == b.keys
            and len(a.children) == len(b.children)
            and all(_is_prefix(x, y) for x, y in zip(a.children, b.children)))


def _batch_spec(shape, mesh, num_clients: int) -> P:
    """One batch leaf's spec: the batch dim over ('pod', 'data'), or for
    C > 1 the client dim on 'pod' and the batch dim on 'data'."""
    if num_clients > 1:
        return P("pod", "data", *([None] * (len(shape) - 2)))
    return batch_pspec(mesh, shape[0], extra_dims=len(shape) - 1)


def batch_specs(model: Model, shape, mesh, sync: SyncConfig) -> dict:
    """``sharding.P`` specs for the input batch of ``shape`` (an
    ``InputShape``; the client dim first when C > 1)."""
    specs = model.input_specs(shape)
    C = sync.num_clients
    if C > 1:
        specs = clientize_batch_specs(specs, C)
    return {k: _batch_spec(tuple(v.shape), mesh, C) for k, v in specs.items()}


def clientize_batch_specs(specs: dict, C: int) -> dict:
    """The batch's ``meta`` stand-ins as (C, B/C, ...): one slice a client."""
    return {k: torch.empty((C, v.shape[0] // C) + tuple(v.shape[1:]),
                           dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def make_grad_fn(model: Model, microbatch: int = 1,
                 pin: Optional[Callable] = None) -> Callable:
    """``(params, batch) -> (loss, metrics, grads)`` for one client.

    ``microbatch`` > 1 splits the batch into M accumulation steps (f32
    accumulator, mean over M, grads cast back to the param dtype); each
    microbatch is rows ``i·B/M : (i+1)·B/M`` of the batch, resharded by
    ``shard_batch_dim``. ``pin(grads, params)`` (leaf lists) lays each
    microbatch's f32 grads out before they join the accumulator — the
    GSPMD step keeps it in the params' placements, the reference's
    ``pin``."""
    pin = pin or (lambda grads, params: grads)

    def single_grad(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss, metrics = model.loss_fn(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    if microbatch <= 1:
        return single_grad
    M = microbatch

    def accum_grad(params, batch):
        B = next(iter(batch.values())).shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} microbatches")
        mb = B // M
        loss_acc, met_acc, g_acc = None, None, None
        p_leaves, treedef = tree_flatten(params)
        for i in range(M):
            sub = {k: shard_batch_dim(v[i * mb:(i + 1) * mb])
                   for k, v in batch.items()}
            loss, metrics, grads = single_grad(params, sub)
            g_leaves = pin([g.float() for g in tree_flatten(grads)[0]], p_leaves)
            if g_acc is None:
                loss_acc, met_acc, g_acc = loss.float(), metrics, g_leaves
            else:
                loss_acc = loss_acc + loss
                met_acc = {k: met_acc[k] + v for k, v in metrics.items()}
                g_acc = [a + g for a, g in zip(g_acc, g_leaves)]
        grads = tree_unflatten(treedef, [(g / M).to(p.dtype)
                                         for g, p in zip(g_acc, p_leaves)])
        return loss_acc / M, {k: v / M for k, v in met_acc.items()}, grads

    return accum_grad


def stacked_grads(grad_fn: Callable, params: Any, batch: dict, ndim: int = 1):
    """Run ``grad_fn`` once per member of params and batch stacked over
    ``ndim`` leading dims (clients, or emulated devices), one member at a
    time so only one member's activations are live; returns the losses
    and metrics stacked over those dims and the grads stacked as the
    params are."""
    lead = tuple(tree_flatten(params)[0][0].shape[:ndim])
    n = math.prod(lead)
    flat = lambda t: t.reshape((n,) + tuple(t.shape[ndim:]))
    p_rows = tree_map(flat, params)
    b_rows = {k: flat(v) for k, v in batch.items()}
    losses, metrics, out = [], {}, None
    for i in range(n):
        loss, met, grads = grad_fn(tree_map(lambda t: t[i], p_rows),
                                   {k: v[i] for k, v in b_rows.items()})
        if out is None:
            out = tree_map(lambda g: g.new_empty((n,) + tuple(g.shape)), grads)
        tree_map(lambda o, g: o[i].copy_(g), out, grads)
        del grads
        losses.append(loss)
        for k, v in met.items():
            metrics.setdefault(k, []).append(v)
    unflat = lambda t: t.reshape(lead + tuple(t.shape[1:]))
    return (unflat(torch.stack(losses)),
            {k: unflat(torch.stack(v)) for k, v in metrics.items()},
            tree_map(unflat, out))


def make_train_step(model: Model, optimizer: Optimizer, sync: SyncConfig,
                    mesh=None, *, microbatch: int = 1,
                    comm: comm_lib.Communicator | None = None,
                    device="cuda", split: Optional[dict] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    reference's ``step_c1`` for C = 1, ``step_multiclient`` for C > 1
    (batch leaves then carry a leading client dim C), ``step_overlap``
    with ``sync.overlap``. With a ``mesh``, the GSPMD step on the DTensor
    state of ``make_train_state(..., mesh=)`` (``make_mesh_step``;
    ``split`` collects its phase times)."""
    device = _mesh_device(device, mesh)
    sync.validate(mesh)
    C = sync.num_clients
    if C > 1:
        # each client updates in its local (p=1) geometry
        comm = comm.local() if comm is not None else None
    if comm is None:
        comm = comm_lib.from_sync(sync)
    stages = schedule = None
    if sync.overlap:
        if microbatch > 1:
            raise ValueError(
                "overlap=True with microbatch>1 would re-issue every "
                "schedule bucket's ring leg per accumulation step (M× the "
                "wire bytes — exactly the traffic overlap exists to "
                "hide); accumulate without overlap, or raise the per-step "
                "batch instead")
        stages, schedule = overlap_schedule(model, sync, comm.resolve_size())
    engine = make_sync_engine(optimizer, sync, mesh, comm=comm,
                              spec=_engine_spec(model, optimizer, sync, mesh),
                              schedule=schedule)
    if mesh is not None:
        return make_mesh_step(model, engine, sync, mesh,
                              microbatch=microbatch, split=split)

    if sync.overlap:
        ograd_fn = make_overlap_grad_fn(model, stages, schedule, comm)

        def step_overlap(state, batch):
            engine.check_opt_layout(state["opt"])
            batch = {k: v.to(device) for k, v in batch.items()}
            loss, metrics, g_shard = ograd_fn(state["params"], batch)
            new_staged, new_o = engine.update_overlapped(
                g_shard, stages.stage(state["params"]), state["opt"])
            del g_shard
            return (
                {"params": stages.unstage(new_staged), "opt": new_o,
                 "step": state["step"] + 1},
                {"loss": loss, **metrics},
            )

        return step_overlap  # overlap is mpi_sgd / C = 1 (validate)

    grad_fn = make_grad_fn(model, microbatch)

    def step_c1(state, batch):
        engine.check_opt_layout(state["opt"])
        batch = {k: v.to(device) for k, v in batch.items()}
        loss, metrics, grads = grad_fn(state["params"], batch)
        new_p, new_o = engine.update(grads, state["opt"], state["params"])
        return (
            {"params": new_p, "opt": new_o, "step": state["step"] + 1},
            {"loss": loss, **metrics},
        )

    def step_multiclient(state, batch):
        engine.check_opt_layout(state["opt"], C)
        batch = {k: v.to(device) for k, v in batch.items()}
        loss, metrics, grads = stacked_grads(grad_fn, state["params"], batch)
        new_p, new_o = engine.update(grads, state["opt"], state["params"])
        del grads
        new_state = dict(state, params=new_p, opt=new_o,
                         step=state["step"] + 1)
        # the pre-increment step gates the exchange, after the update
        if sync.mode == "mpi_esgd" and bool(
                should_elastic_sync(state["step"], sync.esgd_interval)):
            p2, c2 = engine.exchange_multiclient(
                new_state["params"], new_state["center"], sync.esgd_alpha / C)
            new_state = dict(new_state, params=p2, center=c2)
        return new_state, {"loss": loss.mean(),
                           **{k: v.mean() for k, v in metrics.items()}}

    return step_c1 if C <= 1 else step_multiclient


# -- the GSPMD path: DTensor state over a process mesh ----------------------

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def _relayout(new: Any, like: Any) -> Any:
    """Each DTensor of ``new`` in the placements of its twin in ``like``
    (the state keeps its layout step to step, as the reference's
    ``out_shardings``)."""
    def one(n, o):
        if _is_dtensor(n) and tuple(n.placements) != tuple(o.placements):
            return n.redistribute(o.device_mesh, o.placements)
        return n

    return tree_map(one, new, like)


def _contiguous_stride(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()


def _settle(tree: Any) -> None:
    """Wait for every collective still pending under ``tree``'s DTensors
    (their results are waited for lazily, at first use)."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    for x in tree_leaves(tree):
        if _is_dtensor(x):
            local = x.to_local()
            if isinstance(local, AsyncCollectiveTensor):
                local.wait()


class _PhaseTimer:
    """Adds each phase's wall seconds to ``split[name]``, the device
    synchronised at both ends; does nothing when ``split`` is None."""

    def __init__(self, split: Optional[dict], device: torch.device):
        self.split, self.device = split, device

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.split is None:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.split[name] = self.split.get(name, 0.0) + time.perf_counter() - t0


def make_mesh_step(model: Model, engine, sync: SyncConfig, mesh, *,
                   microbatch: int = 1, split: Optional[dict] = None
                   ) -> Callable:
    """The GSPMD step (``make_train_step(..., mesh)``) on the DTensor state
    of ``make_train_state(..., mesh=)``; run by every rank of ``mesh``.

    The batch comes as plain tensors holding the whole global batch on
    every rank (each keeps its shard: the batch dim over ('pod', 'data'),
    or for C > 1 the client dim on 'pod' and the batch dim on 'data'), or
    as DTensors laid out so already.

    ``step_c1``: ``loss_fn`` on the DTensor params and batch, each
    gradient redistributed from the ``Partial`` placements its backward
    leaves to its param's placements — over 'data' ``Partial -> Replicate``
    is the mpi gradient all-reduce, ``Partial -> Shard`` FSDP's
    reduce-scatter — then the per-leaf ``Optimizer.update``. With
    ``microbatch > 1`` each microbatch's f32 grads are laid out so before
    they join the accumulator (the reference's ``pin``).

    ``step_multiclient`` (C > 1, the client dim on 'pod'): each pod's
    ranks compute only their own client — its slice of every leaf viewed
    as a DTensor on the pod's (data, model) sub-mesh, so the gradient
    syncs over 'data' alone — the shard_map-over-'pod' counterpart of the
    reference's vmap over a 'pod'-sharded client dim (indexing a
    'pod'-sharded DTensor by client would gather every client onto every
    pod). The elastic exchange then runs as DTensor ops over the whole
    mesh: ``w − c`` broadcasts the pod-replicated center, the sum over
    clients is partial over 'pod' and becomes an all-reduce.

    Plain tensors built inside the model (RoPE's tables, masks, the aux
    zero) meet DTensors there; ``implicit_replication`` treats them as
    replicated, scoped to this step's forward, backward, update and
    exchange — not to the model code, which stays plain PyTorch.

    Every collective runs in ``mesh.dtensor_collectives()``: gloo ranks
    that hold card tensors stage each through pinned host memory.

    ``split`` (a dict), when given, collects the wall seconds of the
    phases ``fwd_bwd`` (with the tensor-parallel collectives),
    ``grad_sync``, ``update`` and ``exchange``, the device synchronised
    around each."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    C = sync.num_clients
    dm = mesh.dtensor_mesh
    timer = _PhaseTimer(split, mesh.device)
    if C > 1:
        pod = mesh.axes.index("pod")
        client_axes = tuple(a for a in mesh.axes if a != "pod")
        sub = mesh.dtensor_submesh(client_axes)

    def to_param_layout(g, p):
        return g.redistribute(p.device_mesh, p.placements)

    pin = lambda g_leaves, p_leaves: tree_map(to_param_layout, g_leaves, p_leaves)
    grad_fn = make_grad_fn(model, microbatch, pin if microbatch > 1 else None)

    def place_batch(batch: dict) -> dict:
        return {k: distribute(v, _batch_spec(tuple(v.shape), mesh, C), mesh)
                for k, v in batch.items()}

    def client_step(params, opt, batch):
        with implicit_replication():
            with timer("fwd_bwd"):
                loss, metrics, grads = grad_fn(params, batch)
            with timer("grad_sync"):
                grads = tree_map(to_param_layout, grads, params)
                if split is not None:
                    _settle(grads)
            with timer("update"):
                new_p, new_o = engine.update(grads, opt, params)
                new_p, new_o = _relayout(new_p, params), _relayout(new_o, opt)
        return _full(loss), {k: _full(v) for k, v in metrics.items()}, new_p, new_o

    def step_c1(state, batch):
        engine.check_opt_layout(state["opt"])
        with mesh.dtensor_collectives():
            loss, metrics, new_p, new_o = client_step(
                state["params"], state["opt"], place_batch(batch))
        return ({"params": new_p, "opt": new_o, "step": state["step"] + 1},
                {"loss": loss, **metrics})

    # -- C > 1: one client a pod ----------------------------------------
    def to_client(x):
        """This pod's client of ``x`` (client dim 0) on the sub-mesh."""
        pl = list(x.placements)
        local = x.to_local()
        if pl[pod] == Shard(0):
            row = local[0]
        elif pl[pod] == Replicate():
            row = local[mesh.coords["pod"]]
        else:
            raise ValueError(f"client dim laid out as {pl[pod]} on 'pod'")
        sub_pl = []
        for i, q in enumerate(pl):
            if i == pod:
                continue
            if isinstance(q, Shard):
                if q.dim == 0:
                    raise ValueError("only 'pod' may shard the client dim")
                q = Shard(q.dim - 1)
            sub_pl.append(q)
        shape = tuple(x.shape[1:])
        return DTensor.from_local(row, sub, sub_pl, run_check=False,
                                  shape=shape, stride=_contiguous_stride(shape))

    def from_client(y, like):
        """``y`` (this pod's client) back in the client-dim DTensor
        ``like``'s layout."""
        y = _relayout(y, to_client(like))
        pl = [Shard(q.dim + 1) if isinstance(q, Shard) else q
              for q in y.placements]
        pl.insert(pod, Shard(0))
        shape = (C,) + tuple(y.shape)
        x = DTensor.from_local(y.to_local().unsqueeze(0), dm, pl,
                               run_check=False, shape=shape,
                               stride=_contiguous_stride(shape))
        return _relayout(x, like)

    def client_mean(x: torch.Tensor) -> torch.Tensor:
        """The mean over clients of a per-client scalar (one a pod)."""
        pl = [Shard(0) if a == "pod" else Replicate() for a in mesh.axes]
        x = DTensor.from_local(x.reshape(1), dm, pl, run_check=False,
                               shape=(C,), stride=(1,))
        return x.full_tensor().mean()

    def step_multiclient(state, batch):
        engine.check_opt_layout(state["opt"], C)
        view = lambda tree: tree_map(to_client, tree)
        with mesh.dtensor_collectives():
            loss, metrics, new_p, new_o = client_step(
                view(state["params"]), view(state["opt"]), view(place_batch(batch)))
            new_state = dict(state,
                             params=tree_map(from_client, new_p, state["params"]),
                             opt=tree_map(from_client, new_o, state["opt"]),
                             step=state["step"] + 1)
            # the pre-increment step gates the exchange, after the update; a
            # meta step (a trace) has no value and takes the exchange, whose
            # collectives the reference's compiled cond holds too
            step_now = state["step"].to_local()
            if sync.mode == "mpi_esgd" and (step_now.is_meta or bool(
                    should_elastic_sync(step_now, sync.esgd_interval))):
                with implicit_replication(), timer("exchange"):
                    p2, c2 = engine.exchange_multiclient(
                        new_state["params"], new_state["center"],
                        sync.esgd_alpha / C)
                    new_state = dict(new_state,
                                     params=_relayout(p2, new_state["params"]),
                                     center=_relayout(c2, new_state["center"]))
            metrics = {"loss": client_mean(loss),
                       **{k: client_mean(v) for k, v in metrics.items()}}
        return new_state, metrics

    return step_c1 if C <= 1 else step_multiclient


def train_loop(model: Model, optimizer: Optimizer, sync: SyncConfig,
               mesh, batches, *, seed: int = 0, device="cuda",
               log_every: int = 10, callback: Optional[Callable] = None,
               checkpoint_every: int = 0, checkpoint_dir: str = "",
               restore: str = "") -> tuple[dict, list]:
    """Concrete training driver. ``checkpoint_every``/``checkpoint_dir``
    write atomic checkpoints of the whole state every N completed steps;
    ``restore`` loads one and skips the steps it covers (the data is
    deterministic per step, so the resumed curve continues the
    original)."""
    from repro_torch.checkpoint import checkpoint as ckpt

    state = make_train_state(model, optimizer, sync, seed, device=device,
                             mesh=mesh)
    start = 0
    if restore:
        state, meta = ckpt.restore_checkpoint(restore, state)
        start = int(meta.get("step", 0))
    step_fn = make_train_step(model, optimizer, sync, mesh, device=device)
    history = []
    for i, batch in enumerate(batches):
        if i < start:
            continue            # covered by the restored checkpoint
        state, metrics = step_fn(state, batch)
        if i % log_every == 0:
            entry = {k: float(v) for k, v in metrics.items()}
            entry["step"] = i
            history.append(entry)
            if callback:
                callback(entry)
        if (checkpoint_every and checkpoint_dir
                and (i + 1) % checkpoint_every == 0):
            ckpt.save_checkpoint(ckpt.checkpoint_path(checkpoint_dir, i + 1),
                                 state, step=i + 1)
    return state, history


def build_parser() -> argparse.ArgumentParser:
    """The reference worker CLI's flags, defaults and choices
    (``repro/launch/train.py``), plus the port's ``--device``."""
    ap = argparse.ArgumentParser(
        description="per-client training worker (PyTorch port)")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="train_4k",
                    help="job-spec input shape id (recorded)")
    ap.add_argument("--client", type=int, default=0)
    ap.add_argument("--num-clients", type=int, default=1)
    ap.add_argument("--scheduler", default=None,
                    help="scheduler host:port from the job spec (recorded; "
                         "one process runs one client standalone)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--optimizer", default="sgd",
                    choices=("sgd", "adagrad", "adamw"),
                    help="update rule; every choice rides the fused flat "
                         "path when --fused-update is set")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--fused-update", dest="fused_update",
                    action="store_true", default=True)
    ap.add_argument("--no-fused-update", dest="fused_update",
                    action="store_false")
    ap.add_argument("--flat-exchange", dest="flat_exchange",
                    action="store_true", default=True)
    ap.add_argument("--no-flat-exchange", dest="flat_exchange",
                    action="store_false")
    ap.add_argument("--bucket-bytes", type=int, default=0)
    ap.add_argument("--wire-dtype", default="f32",
                    choices=("f32", "bf16", "int8"),
                    help="low-precision wire protocol on the ring hops "
                         "(requires a ring-family --allreduce method; "
                         "f32 = full precision)")
    ap.add_argument("--state-dtype", default="f32", choices=("f32", "bf16"),
                    help="flat optimizer-state stream dtype")
    ap.add_argument("--overlap", action="store_true", default=False,
                    help="backward-overlapped bucketed reduce-scatter: "
                         "stage backprop and issue each schedule bucket's "
                         "ring leg while earlier layers still "
                         "differentiate (forces a ring allreduce and "
                         "num_rings=1)")
    ap.add_argument("--overlap-buckets", type=int, default=4,
                    help="schedule buckets == backward stages "
                         "(1 = degenerate non-overlapped schedule)")
    ap.add_argument("--allreduce", default=None,
                    choices=("psum", "ring", "multi_ring", "tree",
                             "scatter_gather"),
                    help="intra-client collective (default: psum, or ring "
                         "when --wire-dtype is low-precision)")
    ap.add_argument("--num-rings", type=int, default=0,
                    help="concurrent rings for ring-family methods "
                         "(0 = default: 2, or 1 under --overlap)")
    ap.add_argument("--policy", default=None, choices=("auto",),
                    help="'auto' ranks the collective-policy space with the "
                         "cost model (launch.autotune) at --tune-p devices "
                         "and trains under the fastest valid policy")
    ap.add_argument("--tune-p", type=int, default=8,
                    help="devices per client --policy auto scores the "
                         "candidates at")
    ap.add_argument("--faults", default="",
                    help="deterministic fault schedule (core/faults.py "
                         "string form, e.g. 'kill@12:unit=1'); validated "
                         "here, injected by the drivers that own a clock "
                         "(core/algorithms.py, shard_driver.drive)")
    ap.add_argument("--barrier-timeout", type=float, default=None,
                    help="seconds before the sync PS barrier releases with "
                         "the survivor group (kill/drop schedules need it)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in completed steps (0 = off)")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--restore", default="",
                    help="checkpoint to restore params/opt-state/step from")
    ap.add_argument("--full-size", action="store_true",
                    help="full architecture (default: reduced smoke config)")
    ap.add_argument("--transport", default="loopback",
                    choices=("loopback", "tcp"),
                    help="'loopback' runs the standalone in-process worker; "
                         "'tcp' runs a socket transport worker of the PS tier "
                         "(net/worker.py) against --rendezvous")
    ap.add_argument("--rendezvous", default=os.environ.get("REPRO_RDZV_ADDR"),
                    help="rendezvous host:port for --transport tcp (default: "
                         "$REPRO_RDZV_ADDR)")
    ap.add_argument("--mode", default="",
                    help="transport algorithm mode (dist_sgd / dist_esgd); "
                         "the job config from the rendezvous is "
                         "authoritative, this is recorded for the spec")
    ap.add_argument("--problem", default="logreg8",
                    help="transport training problem (net/problem.py; the "
                         "rendezvous' job config names it)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    return ap


def settings_from_args(args: argparse.Namespace):
    """Lower parsed CLI flags as the reference's ``main`` does: ->
    ``(model config, TrainSettings)``. The fault schedule is parsed here,
    so a bad one fails before any compute."""
    from repro_torch.configs.base import TrainSettings, get_config, reduced

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    if args.policy == "auto":
        from repro_torch.configs.base import INPUT_SHAPES
        from repro_torch.launch.autotune import autotune_for_model, format_table

        shape = INPUT_SHAPES.get(args.shape)
        tokens = (shape.seq_len * shape.global_batch if shape is not None
                  else 1 << 20)
        result = autotune_for_model(cfg, p=args.tune_p, tokens_per_step=tokens)
        pol = result.chosen.policy
        print(f"[train] --policy auto: ranked "
              f"{len(result.ranked)} valid / {len(result.pruned)} pruned "
              f"candidates at p={result.p}, "
              f"payload={result.nbytes:.0f} B", flush=True)
        print(format_table(result), flush=True)
    else:
        method = args.allreduce or (
            "psum" if args.wire_dtype == "f32" and not args.overlap else "ring")
        pol = comm_lib.CollectivePolicy(
            method=method,
            num_rings=1 if args.overlap else (args.num_rings or 2),
            bucket_bytes=args.bucket_bytes or None,
            wire_dtype=None if args.wire_dtype == "f32" else args.wire_dtype,
            overlap=args.overlap, overlap_buckets=args.overlap_buckets)
    settings = TrainSettings(lr=args.lr, momentum=args.momentum,
                             optimizer_name=args.optimizer,
                             weight_decay=args.weight_decay,
                             fused_update=args.fused_update,
                             flat_exchange=args.flat_exchange,
                             policy=pol,
                             state_dtype=args.state_dtype,
                             faults=args.faults,
                             barrier_timeout=args.barrier_timeout,
                             checkpoint_every=args.checkpoint_every,
                             restore=args.restore)
    settings.fault_schedule()  # parse errors surface before any compute
    return cfg, settings


def _transport_worker(ap: argparse.ArgumentParser, args) -> list:
    """``--transport tcp``: one socket worker of the PS tier, its rank
    from ``REPRO_RANK`` (else ``--client``); -> its per-step losses."""
    from repro_torch.net.worker import run_worker, write_metrics

    if not args.rendezvous:
        ap.error("--transport tcp needs --rendezvous (or REPRO_RDZV_ADDR in "
                 "the environment)")
    rank = int(os.environ.get("REPRO_RANK", args.client))
    attempt = int(os.environ.get("REPRO_ATTEMPT", "0"))
    out = run_worker(rank=rank, rendezvous_addr=args.rendezvous,
                     transport="tcp", attempt=attempt, device=args.device)
    write_metrics(out, rank, args.rendezvous, "tcp")
    losses = out.get("losses", [])
    print(f"[train] transport worker {rank} done: {len(losses)} steps, "
          f"final loss {losses[-1] if losses else None}", flush=True)
    return losses


def main(argv: Optional[list] = None) -> list:
    """The worker: one process is one client (C = 1 inside it); the job
    spec's ``--client`` picks its data shard, the rest is recorded."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build_model

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.transport == "tcp":
        return _transport_worker(ap, args)
    device = resolve_device(args.device)
    cfg, settings = settings_from_args(args)
    model = build_model(cfg)
    sync = settings.sync_config()
    optimizer = settings.optimizer()
    pipe = TokenPipeline(DataConfig(
        seed=0, vocab_size=min(cfg.padded_vocab, 256), seq_len=64,
        batch_size=8, steps_per_epoch=args.steps, shard=args.client),
        device=device)
    print(f"[train] client {args.client}/{args.num_clients} arch={cfg.name} "
          f"shape={args.shape} scheduler={args.scheduler} "
          f"optimizer={settings.optimizer_name} "
          f"fused_update={settings.fused_update} "
          f"bucket_bytes={settings.bucket_bytes} "
          f"wire_dtype={settings.wire_dtype} "
          f"state_dtype={settings.state_dtype} "
          f"overlap={settings.overlap} "
          f"overlap_buckets={settings.overlap_buckets} "
          f"faults={settings.faults!r} "
          f"barrier_timeout={settings.barrier_timeout} "
          f"device={device}", flush=True)
    _, hist = train_loop(model, optimizer, sync, None, pipe.epoch(0),
                         device=device, log_every=max(args.steps // 10, 1),
                         checkpoint_every=settings.checkpoint_every,
                         checkpoint_dir=args.checkpoint_dir,
                         restore=settings.restore)
    for entry in hist:
        print(f"step {entry['step']:4d} loss {entry['loss']:.4f}", flush=True)
    if hist:
        print(f"[train] done: {len(hist)} log points, "
              f"final loss {hist[-1]['loss']:.4f}", flush=True)
    return hist


if __name__ == "__main__":
    main()
