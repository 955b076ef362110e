"""Rank workers of the process-mesh tests (tests/test_torch_mesh.py,
tests/test_torch_sharded_driver.py, tests/test_torch_cuda.py).

``launch.mesh.spawn_ranks`` pickles a worker by import path and runs it in
each rank as ``fn(mesh, *args)``. This module imports no JAX, so the
spawned ranks import only torch and the port. The suites here run the
same code over an emulated world (the parent's stacked tensors) and over
a process world (a rank's block), so the two can be held ``==``.
"""
from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, reduced
from repro_torch.core import collectives as C, flatbuf
from repro_torch.core.collectives import WireMeter
from repro_torch.core.comm import CollectivePolicy, Communicator
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.launch import mesh as mesh_lib, shard_driver as SD
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import get_optimizer
from repro_torch.tree import tree_map

N = 1037                      # odd: ragged chunks and int8 buckets
WIRES = (None, "bf16", "int8")
RINGS = (1, 2)
METHODS = ("ring", "multi_ring", "tree", "psum", "scatter_gather")
#: the schedule-bucketed legs' layout: three leaves, one bucket each
SCHED_LEAVES = (300, 517, 220)


def schedule(p: int) -> flatbuf.BucketSchedule:
    spec = flatbuf.spec_for({f"l{i}": torch.zeros(n)
                             for i, n in enumerate(SCHED_LEAVES)})
    return flatbuf.bucket_schedule(spec, (1,) * len(SCHED_LEAVES), p)


def suite_keys(axes) -> list:
    """The result names of ``collectives_suite`` over a world of ``axes``."""
    keys = []
    for wire in WIRES:
        for r in RINGS:
            keys += [f"rs/{wire}/{r}", f"ag/{wire}/{r}", f"select/{wire}/{r}",
                     f"sg/{wire}/{r}"]
        keys += [f"bucket_rs/{wire}", f"world_rs/{wire}", f"world_ag/{wire}",
                 f"world_ar/{wire}", f"world_bucket_rs/{wire}",
                 f"world_ag_sched/{wire}"]
    keys += [f"allreduce/{m}" for m in METHODS]
    keys += ["world_select_sched", "world_tree", "world_psum", "world_pmean",
             "tensor_allreduce_mean", "pushpull_tree"]
    if len(axes) > 1:
        for g in axes:
            keys += [f"split_{g}_rs/int8", f"split_{g}_ar", f"split_{g}_pmean"]
    return keys


def collectives_suite(world: Communicator, x: torch.Tensor) -> dict:
    """Every collective of the port on ``x`` — the stacked ``(*world, N)``
    value (emulated) or this rank's block of it (process): the free ring
    functions along the world's innermost axis (batched over the others),
    then the ``Communicator`` over the whole world and its splits. Each
    ring result is paired with the bytes ONE device put on the wire."""
    out: dict = {}
    dim = world._dim(world.axes[-1])
    p_in = world.sizes[-1]
    sched = schedule(world.static_size)
    sched_in = schedule(p_in)
    for wire in WIRES:
        for r in RINGS:
            m = WireMeter()
            rs = C.ring_reduce_scatter(x, dim, num_rings=r, wire_dtype=wire,
                                       meter=m)
            out[f"rs/{wire}/{r}"] = (rs, m.bytes)
            m = WireMeter()
            ag = C.ring_allgather(rs, dim, num_rings=r, wire_dtype=wire,
                                  meter=m)
            out[f"ag/{wire}/{r}"] = (ag, m.bytes)
            out[f"select/{wire}/{r}"] = (C.shard_select(ag, dim, num_rings=r),
                                         0)
            m = WireMeter()
            out[f"sg/{wire}/{r}"] = (C.scatter_gather_allreduce(
                x, dim, num_rings=r, wire_dtype=wire, meter=m), m.bytes)
        m = WireMeter()
        out[f"bucket_rs/{wire}"] = (torch.cat([
            C.sched_reduce_scatter_bucket(
                x[..., s:s + n], dim, sched_in, b, wire_dtype=wire, meter=m)
            for b, (s, n) in enumerate(zip(sched_in.starts, sched_in.sizes))],
            -1), m.bytes)
        m = WireMeter()
        w = world.with_policy(method="ring", num_rings=2, wire_dtype=wire)
        w = Communicator.world(w.axes, w.sizes, policy=w.policy, meter=m,
                               mesh=world.mesh)
        _, total = w.shard_geometry(N)
        padded = C._pad_to(x, total)
        shard = w.reduce_scatter(padded)
        out[f"world_rs/{wire}"] = (shard, m.bytes)
        m.reset()
        out[f"world_ag/{wire}"] = (w.allgather(shard), m.bytes)
        m.reset()
        out[f"world_ar/{wire}"] = (w.allreduce(x), m.bytes)
        m.reset()
        chunks = [w.with_policy(num_rings=1).reduce_scatter_bucket(
            x[..., s:s + n], sched, b)
            for b, (s, n) in enumerate(zip(sched.starts, sched.sizes))]
        out[f"world_bucket_rs/{wire}"] = (torch.cat(chunks, -1), m.bytes)
        m.reset()
        out[f"world_ag_sched/{wire}"] = (
            w.allgather_sched(torch.cat(chunks, -1), sched), m.bytes)
    for method in METHODS:
        out[f"allreduce/{method}"] = (C.allreduce(x, dim, method, num_rings=2),
                                      0)
    w = world.with_policy(method="ring", num_rings=1, wire_dtype=None)
    out["world_select_sched"] = (w.shard_select_sched(x, sched), 0)
    out["world_tree"] = (world.with_policy(method="tree").allreduce(x), 0)
    out["world_psum"] = (world.with_policy(method="psum").allreduce(x), 0)
    out["world_pmean"] = (world.pmean(x[..., :3]), 0)
    lead = tuple(x.shape[:len(world.frame)])
    tree = {"w": x[..., :300].reshape(lead + (10, 30)), "b": x[..., 300:317]}
    out["tensor_allreduce_mean"] = (w.tensor_allreduce(tree, mean=True), 0)
    out["pushpull_tree"] = (w.pushpull(tree, fused=False), 0)
    if len(world.axes) > 1:
        for g in world.axes:
            sub = world.split(g)
            m = WireMeter()
            s8 = Communicator.world(world.axes, world.sizes, meter=m,
                                    mesh=world.mesh, policy=CollectivePolicy(
                                        method="ring", num_rings=2,
                                        wire_dtype="int8")).split(g)
            _, total = s8.shard_geometry(N)
            out[f"split_{g}_rs/int8"] = (s8.reduce_scatter(C._pad_to(x, total)),
                                         m.bytes)
            out[f"split_{g}_ar"] = (sub.with_policy(method="ring").allreduce(x),
                                    0)
            out[f"split_{g}_pmean"] = (sub.pmean(x[..., :3]), 0)
    return out


def block_of(stacked: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a ``(p_total, …)`` stacked tensor, with the
    mesh's axes as leading size-1 dims."""
    row = stacked[mesh.index:mesh.index + 1]
    return row.reshape((1,) * len(mesh.axes) + tuple(stacked.shape[1:]))


def collectives_rank(mesh, x: torch.Tensor) -> dict:
    """The suite over this rank's block of ``x`` (``(p_total, N)``)."""
    world = Communicator.world(mesh.axes, mesh=mesh,
                               policy=CollectivePolicy(method="ring"))
    return collectives_suite(world, block_of(x, mesh))


def mesh_rank(mesh) -> dict:
    """What a rank sees of its mesh, its groups and the production
    meshes; the ranks return in reverse order (rank 0 last)."""
    groups = {a: dist.get_process_group_ranks(mesh.get_group(a))
              for a in mesh.axes}
    groups["flat"] = dist.get_process_group_ranks(mesh.get_group(mesh.axes))
    world = Communicator.world(mesh.axes, mesh=mesh)
    errors = {}
    for name, make in (("production", mesh_lib.make_production_mesh),
                       ("production_multi", lambda: mesh_lib.make_production_mesh(
                           multi_pod=True)),
                       ("moe", mesh_lib.make_moe_mesh)):
        try:
            make()
        except ValueError as e:
            errors[name] = str(e)
    host = mesh_lib.make_host_mesh(2, mesh.size // 2, device="cpu")
    out = {"rank": dist.get_rank(), "shape": mesh.shape, "coords": mesh.coords,
           "index": mesh.index, "groups": groups, "backend": mesh.backend,
           "device": str(mesh.device), "comm_backend": world.backend,
           "sizes": world.sizes, "chips": mesh_lib.mesh_num_chips(mesh),
           "errors": errors, "host_shape": host.shape,
           "host_coords": host.coords, "threads": torch.get_num_threads()}
    time.sleep(0.3 * (mesh.size - mesh.index))
    return out


def failing_rank(mesh, bad: int) -> int:
    if mesh.index == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    return mesh.index


# ---------------------------------------------------------------------------
# the shard driver
# ---------------------------------------------------------------------------

HYPER = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=3e-3),
         "adagrad": dict(lr=0.05)}


def sync_for(case: dict) -> SyncConfig:
    """A case's SyncConfig: mode, clients, wire, overlap."""
    pol = dict(method="ring", num_rings=1 if case.get("overlap") else 2,
               wire_dtype=case.get("wire"), overlap=bool(case.get("overlap")))
    return SyncConfig(mode=case["mode"], num_clients=case.get("clients", 1),
                      esgd_interval=2, esgd_alpha=0.5,
                      policy=CollectivePolicy(**pol))


def model():
    return build_model(reduced(get_config("qwen2-0.5b")))


def stack_params(params, n: int):
    """``params`` with a leading device dim of ``n`` (replicas)."""
    return tree_map(lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape))
                    .clone(), params)


def run_case(step, state, batches, split, meter) -> tuple:
    metrics, wire = [], []
    for b in batches:
        meter.reset()
        state, met = step(state, split(b))
        metrics.append({k: v.clone() for k, v in met.items()})
        wire.append(meter.bytes)
    return state, metrics, wire


def emulated_case(case: dict, p, params, batches, device="cpu") -> dict:
    """A case through ``make_emulated_step`` on the stacked state, from
    ``params`` (replicated to every device, and the center)."""
    mdl, sync = model(), sync_for(case)
    opt = get_optimizer(case["opt"], **HYPER[case["opt"]])
    state = SD.make_driver_state(mdl, opt, sync, p, device=device)
    n = state["step"].shape[0]
    for key in ("params", "center"):
        if key in state:
            state[key] = stack_params(tree_map(lambda t: t.to(device), params),
                                      n)
    meter = WireMeter()
    step = SD.make_emulated_step(mdl, opt, sync, p, meter=meter,
                                 microbatch=case.get("microbatch", 1))
    state, metrics, wire = run_case(step, state, batches,
                                    lambda b: SD.shard_batch(b, p), meter)
    return {"state": state, "metrics": metrics, "wire": wire}


def sharded_case(mesh, case: dict, params, batches) -> dict:
    """A case through ``make_sharded_step`` on this rank's block."""
    mdl, sync = model(), sync_for(case)
    opt = get_optimizer(case["opt"], **HYPER[case["opt"]])
    p, _ = SD._mesh_geometry(mesh)
    state = SD.make_driver_state(mdl, opt, sync, mesh=mesh)
    for key in ("params", "center"):
        if key in state:
            state[key] = stack_params(
                tree_map(lambda t: t.to(mesh.device), params), 1)
    meter = WireMeter()
    step = SD.make_sharded_step(mdl, opt, sync, mesh, meter=meter,
                                microbatch=case.get("microbatch", 1))
    state, metrics, wire = run_case(
        step, state, batches,
        lambda b: SD.rank_block(SD.shard_batch(b, p), mesh), meter)
    return {"state": state, "metrics": metrics, "wire": wire}


def driver_rank(mesh, cases: list, params, batches) -> list:
    return [sharded_case(mesh, c, params, batches) for c in cases]


#: the packages the port and its ranks never import
FOREIGN = ("jax", "jaxlib", "repro", "ml_dtypes")


def purity_rank(mesh) -> list:
    """One ``drive(mesh=)`` step of the reduced model, then the foreign
    modules this rank imported."""
    toks = torch.zeros((2 * mesh.size, 8), dtype=torch.int32)
    _, hist = SD.drive(model(), get_optimizer("sgd", **HYPER["sgd"]),
                       SyncConfig(), [{"tokens": toks, "labels": toks}],
                       mesh=mesh)
    assert len(hist) == 1
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
