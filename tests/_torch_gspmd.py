"""Rank workers of the GSPMD-path tests (tests/test_torch_gspmd.py,
tests/test_torch_cuda.py): the reduced qwen2-0.5b trained through
``make_train_state(..., mesh=)`` / ``make_train_step(..., mesh)`` on
DTensor state, and the same cases through the one-process per-leaf step
(``mesh=None``, ``fused_update=False``) they are held to.

``launch.mesh.spawn_ranks`` pickles a worker by import path and runs it in
each rank as ``fn(mesh, *args)``. This module imports no JAX.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as T
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import adagrad, adamw, sgd
from repro_torch.tree import tree_map

STEPS = 3
BATCH, SEQ = 8, 32

#: case name -> (mesh shape, the case). AdamW and AdaGrad take a larger
#: eps than their defaults (1e-3, 1e-2): they divide each coordinate by
#: its own gradient's size, which turns the noise of two reduction orders
#: in a tiny gradient into a visible step (ROADMAP's parity traps), and the
#: final params are held here at rtol 1e-5.
CASES = {
    "sgd": ((2, 2), dict(opt="sgd")),
    "adamw": ((2, 2), dict(opt="adamw")),
    "adagrad": ((2, 2), dict(opt="adagrad")),
    "fsdp": ((2, 2), dict(opt="sgd", fsdp=True)),
    "seq_shard": ((2, 2), dict(opt="sgd", seq_shard=True)),
    "microbatch2": ((2, 2), dict(opt="sgd", microbatch=2)),
    "esgd_c2": ((2, 1, 2), dict(opt="sgd", mode="mpi_esgd", clients=2)),
}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def optimizer(name: str):
    return {"sgd": lambda: sgd(0.1, 0.9),
            "adamw": lambda: adamw(1e-3, eps=1e-3),
            "adagrad": lambda: adagrad(1e-2, eps=1e-2)}[name]()


def model(seq_shard: bool = False):
    cfg = reduced(get_config("qwen2-0.5b"))
    return build_model(dataclasses.replace(cfg, seq_shard_activations=seq_shard))


def sync_config(case: dict) -> SyncConfig:
    """The case's SyncConfig; per-leaf (the mesh path is per-leaf anyway,
    and the one-process oracle must be too)."""
    return SyncConfig(mode=case.get("mode", "mpi_sgd"),
                      num_clients=case.get("clients", 1), esgd_alpha=0.5,
                      esgd_interval=2, fsdp=case.get("fsdp", False),
                      fused_update=False, flat_exchange=False)


def batches(clients: int = 1) -> list:
    """STEPS batches of BATCH × SEQ tokens; for C > 1 one pipeline shard a
    client, stacked (C, BATCH / C, SEQ)."""
    out = []
    for i in range(STEPS):
        if clients == 1:
            out.append(TokenPipeline(DataConfig(
                seed=0, vocab_size=256, seq_len=SEQ, batch_size=BATCH),
                device="cpu").batch_at(0, i))
            continue
        parts = [TokenPipeline(DataConfig(
            seed=0, vocab_size=256, seq_len=SEQ, batch_size=BATCH // clients,
            shard=c), device="cpu").batch_at(0, i) for c in range(clients)]
        out.append({k: torch.stack([p[k] for p in parts]) for k in parts[0]})
    return out


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def run_case(mesh, case: dict, device="cpu", seed: int = 0) -> dict:
    """``STEPS`` steps of ``case`` from the seed's params: on the DTensor
    state of ``mesh``, or in one process with ``mesh=None``. Returns the
    losses, the whole final state (gathered) and, on a mesh, what each
    call of the model's loss saw: this rank's pod coordinate and the
    tokens it held (local rows, and the global shape of its view)."""
    m = model(case.get("seq_shard", False))
    seen = []
    loss_fn = m.loss_fn

    def counted(p, b):
        toks = b["tokens"]
        seen.append((tuple(toks.shape), toks.to_local().cpu()
                     if hasattr(toks, "to_local") else toks.cpu()))
        return loss_fn(p, b)

    m = dataclasses.replace(m, loss_fn=counted)
    opt, sync = optimizer(case["opt"]), sync_config(case)
    state = T.make_train_state(m, opt, sync, seed, device=device, mesh=mesh)
    step = T.make_train_step(m, opt, sync, mesh, device=device,
                             microbatch=case.get("microbatch", 1))
    losses = []
    for b in batches(sync.num_clients):
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    ctx = mesh.dtensor_collectives() if mesh is not None else None
    if ctx is not None:
        with ctx:
            state = tree_map(_full, state)
    return {"losses": losses, "state": tree_map(lambda t: t.cpu(), state),
            "seen": seen,
            "pod": mesh.coords.get("pod") if mesh is not None else None}


def mesh_rank(mesh, names, device="cpu") -> dict:
    """One rank of a mesh run: every case of ``names`` in turn."""
    return {name: run_case(mesh, CASES[name][1], device=device) for name in names}


def case_rank(mesh, case: dict, device="cpu") -> dict:
    """One rank of a mesh run of one ``case``."""
    return run_case(mesh, case, device=device)
