"""Rank worker of the remat test on a mesh (tests/test_torch_remat.py): the
reduced qwen2-0.5b, sequence-sharded between blocks, trained through the
GSPMD step (``make_train_step(..., mesh)``) on a sequence of two loss
chunks; and the same steps in one process (``mesh=None``, per-leaf),
which they are held to.

``launch.mesh.spawn_ranks`` pickles the worker by import path and runs it
in each rank as ``fn(mesh, *args)``. This module imports no JAX.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as T
from repro_torch.models.model import XENT_CHUNK, build_model
from repro_torch.optim.sgd import sgd
from repro_torch.tree import tree_map

STEPS = 2
#: one sequence a data rank, two loss chunks long
BATCH, SEQ = 2, 2 * XENT_CHUNK


def run(mesh, remat: bool) -> dict:
    """``STEPS`` momentum-SGD steps from seed 0: on ``mesh`` (DTensor
    state, the gathered final params returned) or in one process."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), remat=remat,
                              seq_shard_activations=True)
    model, opt = build_model(cfg), sgd(0.1, 0.9)
    sync = SyncConfig(mode="mpi_sgd", fused_update=False, flat_exchange=False)
    state = T.make_train_state(model, opt, sync, 0, device="cpu", mesh=mesh)
    step = T.make_train_step(model, opt, sync, mesh, device="cpu")
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=SEQ,
                                    batch_size=BATCH), device="cpu")
    losses = []
    for i in range(STEPS):
        state, met = step(state, pipe.batch_at(0, i))
        losses.append(float(met["loss"]))
    params = state["params"]
    if mesh is not None:
        with mesh.dtensor_collectives():
            params = tree_map(lambda t: t.full_tensor(), params)
    return {"losses": losses, "params": tree_map(lambda t: t.cpu(), params)}
