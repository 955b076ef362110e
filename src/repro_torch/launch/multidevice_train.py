"""Execute the sharded train step (the GSPMD path) on a real world of
processes (``examples/multidevice_train.py``): 8 ranks as (pod 2, data 2,
model 2) — a miniature of the two-pod production layout — one process a
rank, gloo between them. Runs mpi-ESGD: two clients with their own
replicas, each pod's ranks training their own client (batch over 'data',
tensor parallelism over 'model'), the elastic exchange across 'pod' every
4 steps.

  python -m repro_torch.launch.multidevice_train               # on the card
  python -m repro_torch.launch.multidevice_train --device cpu

On one card the 8 ranks share it (NCCL refuses two ranks a card), each
with its own CUDA context; DTensor's collectives are staged through
pinned host memory (``sharding/staging.py``).
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.hierarchy import SyncConfig, declientize
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.train import make_train_state, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import sgd
from repro_torch.tree import tree_leaves

SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
STEPS, CLIENTS, INTERVAL = 12, 2, 4


def rank_main(mesh, steps: int) -> dict:
    """One rank: the example's run; returns its printed lines."""
    lines = [f"mesh: {mesh.shape} over {mesh.size} devices"]
    model = build_model(reduced(get_config("qwen2-0.5b")))
    optimizer = sgd(0.1, momentum=0.9)
    sync = SyncConfig(mode="mpi_esgd", num_clients=CLIENTS, esgd_alpha=0.5,
                      esgd_interval=INTERVAL)
    sync.validate(mesh)
    dev = mesh.device.type
    # the same mesh for both factories: the GSPMD path keeps per-leaf layouts
    state = make_train_state(model, optimizer, sync, 0, device=dev, mesh=mesh)
    step = make_train_step(model, optimizer, sync, mesh, device=dev)
    pipes = [TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=64,
                                      batch_size=4, shard=c), device="cpu")
             for c in range(CLIENTS)]
    losses = []
    for i in range(steps):
        parts = [p.batch_at(0, i) for p in pipes]
        batch = {k: torch.stack([b[k] for b in parts]) for k in parts[0]}
        state, metrics = step(state, batch)
        with mesh.dtensor_collectives():
            spread = max(float((p[0] - p[1]).abs().max().full_tensor())
                         for p in tree_leaves(state["params"]))
        loss = float(metrics["loss"])
        losses.append(loss)
        mark = " <- elastic exchange" if i % INTERVAL == 0 else ""
        lines.append(f"step {i:2d} loss {loss:.4f} replica spread "
                     f"{spread:.4f}{mark}")
    with mesh.dtensor_collectives():
        final = declientize(state["params"], CLIENTS)
        n = sum(leaf.numel() for leaf in tree_leaves(final))
    lines.append(f"consensus model: {n:,} params, all shards on "
                 f"{mesh.size} devices executed SPMD")
    return {"lines": lines, "losses": losses}


def run(device="cuda", steps: int = STEPS) -> list:
    """Spawn the 8 ranks; -> every rank's result, ordered by rank."""
    return spawn_ranks(rank_main, SHAPE, AXES, backend="gloo", device=device,
                       args=(steps,))


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda: all "
                         "ranks share the card; cpu runs on the host)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    out = run(args.device, args.steps)
    for line in out[0]["lines"]:
        print(line, flush=True)
    return out[0]


if __name__ == "__main__":
    main()
