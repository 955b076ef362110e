"""Quickstart: train a reduced-config model with the production train step
(KVStore-MPI semantics: mpi-SGD, one client) on the synthetic bigram
language, checkpoint it, and serve a few tokens — the port of
``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch qwen2-0.5b] [--steps 60]
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Runs on the card unless ``--device cpu`` is given. The train step is the
port's main path: ``make_train_state`` -> ``make_train_step`` ->
``FlatEngine`` -> the fused momentum-SGD kernel on the card.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Optional

import torch

from repro_torch.checkpoint.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.serve import BatchedServer
from repro_torch.launch.train import make_train_state, make_train_step, resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import sgd
from repro_torch.tree import tree_leaves, tree_map


def run(arch: str = "qwen2-0.5b", steps: int = 60, lr: float = 0.1, *,
        device="cuda", params: Any = None) -> dict:
    """The example's sequence on ``device``: ``steps`` mpi-SGD steps of
    the reduced ``arch`` from ``params`` (default: ``model.init`` at seed
    0), an npz checkpoint round trip into zeros, then 12 greedy tokens
    for two 8-token prompts from ``BatchedServer(batch=2, max_seq=96)``.
    Returns the losses, the trained and the restored params, the
    prompts and the greedy tokens."""
    device = resolve_device(device)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    n = sum(leaf.numel() for leaf in tree_leaves(model.init(device="meta")))
    print(f"arch={cfg.name} (reduced: {cfg.num_layers}L d={cfg.d_model}) "
          f"params={n:,}")

    # vocab 256 keeps the bigram automaton learnable in ~60 steps
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=64,
                                    batch_size=8, steps_per_epoch=steps),
                         device=device)
    floor = pipe.optimal_xent()
    print(f"loss floor (automaton entropy): {floor:.3f}")

    optimizer = sgd(lr, momentum=0.9)
    sync = SyncConfig(mode="mpi_sgd", num_clients=1)
    state = make_train_state(model, optimizer, sync, device=device)
    if params is not None:
        state["params"] = tree_map(lambda a: a.to(device), params)
    step = make_train_step(model, optimizer, sync, device=device)

    losses = []
    for i, batch in enumerate(pipe.epoch(0)):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save_checkpoint(path, state["params"], step=steps)
        restored, meta = restore_checkpoint(
            path, tree_map(torch.zeros_like, state["params"]))
        print(f"checkpoint round-trip ok (step {meta['step']})")

    srv = BatchedServer(model, restored, batch=2, max_seq=96, device=device)
    prompts = pipe.batch_at(1, 0)["tokens"][:2, :8]
    out = srv.generate(prompts, steps=12)
    print(f"prompt : {prompts.tolist()}")
    print(f"greedy : {out.tolist()}")
    return {"model": model, "nparams": n, "floor": floor, "losses": losses,
            "params": state["params"], "restored": restored,
            "step": meta["step"], "prompts": prompts, "tokens": out,
            "device": device}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return run(args.arch, args.steps, args.lr, device=args.device)


if __name__ == "__main__":
    main()
