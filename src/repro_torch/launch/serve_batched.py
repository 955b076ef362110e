"""Batched serving: greedy decoding with a KV (or recurrent-state) cache
across three architecture families — dense GQA, SSM and hybrid — the
port of ``examples/serve_batched.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_batched
  PYTHONPATH=src python -m repro_torch.launch.serve_batched --device cpu

Runs on the card unless ``--device cpu`` is given; the printed rate names
the device it was measured on.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.serve import BatchedServer
from repro_torch.launch.train import resolve_device
from repro_torch.models.model import build_model
from repro_torch.tree import tree_map

ARCHS = ("qwen2-0.5b", "mamba2-130m", "zamba2-1.2b")


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device type."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def serve_arch(arch: str, *, device="cuda", params: Any = None,
               prompts: Optional[torch.Tensor] = None, steps: int = 16,
               batch: int = 4, max_seq: int = 64) -> dict:
    """``steps`` greedy tokens per slot of ``BatchedServer(batch,
    max_seq)`` on the reduced ``arch`` from ``params`` (default:
    ``model.init`` at seed 0) after ``prompts`` (default: (batch, 6)
    tokens drawn from a generator at seed 1). Returns the tokens, the
    prompts and the wall seconds of ``generate``, which ends in a sync."""
    device = resolve_device(device)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    if params is None:
        params = model.init(device=device, seed=0)
    params = tree_map(lambda a: a.to(device), params)
    if prompts is None:
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (batch, 6), generator=gen,
                                dtype=torch.int32)
    srv = BatchedServer(model, params, batch=batch, max_seq=max_seq,
                        device=device)
    t0 = time.perf_counter()
    out = srv.generate(prompts, steps=steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return {"arch": arch, "arch_type": cfg.arch_type, "tokens": out,
            "prompts": prompts, "seconds": dt, "vocab_size": cfg.vocab_size}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    where = device_name(device)
    out = {}
    for arch in ARCHS:
        res = serve_arch(arch, device=device)
        toks, dt = res["tokens"].numel(), res["seconds"]
        print(f"{arch:14s} [{res['arch_type']:6s}] generated {toks} tokens in "
              f"{dt:.2f}s ({toks / dt:.0f} tok/s on {where}) "
              f"sample={res['tokens'][0, :8].tolist()}")
        out[arch] = res
    return out


if __name__ == "__main__":
    main()
