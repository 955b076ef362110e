"""mpi-ESGD with the production train step: two clients (the multi-pod
layout) doing local sync-SGD with lazy elastic exchange — the paper's
path to cluster-wide scaling — against fully-synchronous mpi-SGD at the
same token budget; the port of ``examples/esgd_multipod.py``.

The C > 1 path is the 2-axis pod × data shard driver (the default): each
client is one pod of ``--data-per-pod`` emulated devices, the gradient
leg reduce-scatters over the ``data`` communicator inside the pod, and
the elastic exchange is the only traffic crossing the ``pod``
communicator. ``--driver vmap`` runs the single-process stacked-client
step instead; both run the same flat-substrate math and their losses
agree to float tolerance.

  PYTHONPATH=src python -m repro_torch.launch.esgd_multipod [--steps 80]
  PYTHONPATH=src python -m repro_torch.launch.esgd_multipod --driver vmap --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import Any, Optional

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.hierarchy import SyncConfig, clientize, declientize
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import shard_driver
from repro_torch.launch.train import make_train_state, make_train_step, resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import sgd
from repro_torch.tree import tree_map


def _replicate(params: Any, n: int, device) -> Any:
    """``params`` on ``device`` with a leading dim of ``n`` copies."""
    return tree_map(lambda a: a.to(device).unsqueeze(0).expand(
        (n,) + tuple(a.shape)).clone(), params)


def run_mode(model, sync: SyncConfig, pipes, steps: int, lr: float,
             driver: str = "shard", data_per_pod: int = 2,
             params: Any = None, *, device="cuda") -> tuple[list, Any]:
    """``steps`` steps of momentum SGD under ``sync`` on the first epoch
    of each client's pipeline, from ``params`` (default: ``model.init`` at
    seed 0). C > 1 with ``driver="shard"`` runs the emulated (C,
    data_per_pod) shard driver; otherwise ``make_train_step`` on the
    clients stacked (C > 1) or on the pipelines' batches joined (C = 1).
    Returns the per-step losses and the consensus params."""
    device = resolve_device(device)
    optimizer = sgd(lr, momentum=0.9)
    C = sync.num_clients
    sharded = driver == "shard" and C > 1
    if sharded:
        # one pod per client, data_per_pod devices inside each: the
        # 2-axis pod x data hierarchy as one emulated world
        geom = (C, data_per_pod)
        state = shard_driver.make_driver_state(model, optimizer, sync, geom,
                                               device=device)
        step = shard_driver.make_emulated_step(model, optimizer, sync, geom)
        if params is not None:
            n = C * data_per_pod
            state["params"] = _replicate(params, n, device)
            state["center"] = _replicate(params, n, device)
    else:
        state = make_train_state(model, optimizer, sync, device=device)
        step = make_train_step(model, optimizer, sync, device=device)
        if params is not None:
            state["params"] = clientize(tree_map(lambda a: a.to(device), params), C)
            if "center" in state:
                state["center"] = tree_map(lambda a: a.to(device), params)
    losses = []
    for i in range(steps):
        batches = [p.batch_at(0, i) for p in pipes]
        if sharded:
            batch = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
            batch = shard_driver.shard_batch(batch, geom)
        elif C > 1:
            batch = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        else:
            batch = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    replicas = C * data_per_pod if sharded else C
    return losses, declientize(state["params"], replicas)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--driver", choices=("vmap", "shard"), default="shard",
                    help="'shard' (default): the 2-axis pod x data driver "
                         "(launch/shard_driver.py, emulated axes); 'vmap': "
                         "the single-process stacked-client step")
    ap.add_argument("--data-per-pod", type=int, default=2,
                    help="devices per pod-client on the shard driver's "
                         "'data' axis (the intra-client communicator)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = build_model(reduced(get_config("qwen2-0.5b")))
    pipes = [TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=48,
                                      batch_size=4, steps_per_epoch=args.steps,
                                      shard=c), device=device)
             for c in range(2)]

    print("== mpi-SGD (1 client, every-step global sync) ==")
    sgd_losses, _ = run_mode(model, SyncConfig(mode="mpi_sgd", num_clients=1),
                             pipes, args.steps, lr=0.1, device=device)
    print("== mpi-ESGD (2 clients, elastic exchange every "
          f"{args.interval} steps, driver={args.driver}) ==")
    esgd_losses, params = run_mode(
        model, SyncConfig(mode="mpi_esgd", num_clients=2, esgd_alpha=0.5,
                          esgd_interval=args.interval),
        pipes, args.steps, lr=0.1, driver=args.driver,
        data_per_pod=args.data_per_pod, device=device)

    print(f"\n{'step':>5s} {'mpi_sgd':>8s} {'mpi_esgd':>9s}")
    for i in range(0, args.steps, 10):
        print(f"{i:5d} {sgd_losses[i]:8.4f} {esgd_losses[i]:9.4f}")
    print(f"final {sgd_losses[-1]:8.4f} {esgd_losses[-1]:9.4f}")
    syncs_sgd = args.steps
    syncs_esgd = args.steps // args.interval
    print(f"\ncross-client syncs: mpi_sgd={syncs_sgd} "
          f"mpi_esgd={syncs_esgd} ({syncs_sgd // syncs_esgd}x fewer)")
    return {"sgd_losses": sgd_losses, "esgd_losses": esgd_losses,
            "params": params, "syncs": (syncs_sgd, syncs_esgd),
            "device": device}


if __name__ == "__main__":
    main()
