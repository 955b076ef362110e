"""The paper end to end: all six parallel-SGD modes (dist/mpi x
SGD/ASGD/ESGD) training the paper's model family (a compact ResNet) on
synthetic ImageNet-like data, through the KVStore API, with simulated
cluster timing — the port of ``examples/hybrid_ps_mpi.py``.

  PYTHONPATH=src python -m repro_torch.launch.hybrid_ps_mpi [--epochs 3]
  PYTHONPATH=src python -m repro_torch.launch.hybrid_ps_mpi --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from repro_torch.configs.resnet50_cifar import ResNetConfig
from repro_torch.core.algorithms import MODES, AlgoConfig, History, run
from repro_torch.data.pipeline import DataConfig, ImagePipeline
from repro_torch.launch.train import resolve_device
from repro_torch.models.resnet import init_resnet, resnet_apply, resnet_loss
from repro_torch.tree import tree_flatten, tree_unflatten

#: the example's ResNet: two stages of one block, width 8, 8 px images
EXAMPLE = ResNetConfig(stage_sizes=(1, 1), width=8, image_size=8)


def make_grad_fn(rcfg: ResNetConfig) -> Callable:
    """``(params, batch) -> (loss, grads)``, grads in the tree's shape:
    one ``torch.autograd.grad`` of ``resnet_loss``."""

    def grad_fn(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss, _ = resnet_loss(tree_unflatten(treedef, leaves), batch, rcfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(treedef, list(grads))

    return grad_fn


def make_eval_fn(rcfg: ResNetConfig, batch: dict) -> Callable:
    """``params -> float``: top-1 accuracy on one held-out batch."""

    @torch.no_grad()
    def eval_fn(params) -> float:
        logits = resnet_apply(params, batch["images"], rcfg)
        hit = torch.argmax(logits, -1) == batch["labels"].long()
        return float(torch.mean(hit.float()))

    return eval_fn


def held_out_batch(rcfg: ResNetConfig, device) -> dict:
    """The example's held-out batch: 256 images of shard 999, epoch 99."""
    pipe = ImagePipeline(DataConfig(seed=0, batch_size=256, steps_per_epoch=1,
                                    shard=999),
                         image_size=rcfg.image_size,
                         num_classes=rcfg.num_classes, device=device)
    return pipe.batch_at(99, 0)


def make_pipeline(rcfg: ResNetConfig, device, steps_per_epoch: int) -> Callable:
    """``worker -> ImagePipeline`` of 8-image batches over that worker's
    shard."""
    def make(w: int) -> ImagePipeline:
        return ImagePipeline(DataConfig(seed=0, batch_size=8,
                                        steps_per_epoch=steps_per_epoch, shard=w),
                             image_size=rcfg.image_size,
                             num_classes=rcfg.num_classes, device=device)
    return make


def example_config(mode: str, *, epochs: int = 3, workers: int = 4,
                   clients: int = 2, **kw) -> AlgoConfig:
    """The example's ``AlgoConfig`` for ``mode``; ``kw`` overrides fields."""
    base = dict(mode=mode, num_workers=workers, num_clients=clients,
                num_servers=1, lr=0.1, momentum=0.9, epochs=epochs,
                steps_per_epoch=10, esgd_interval=4, compute_time=0.45,
                jitter=0.2, model_bytes=1e8)
    return AlgoConfig(**{**base, **kw})


def run_example(cfg: AlgoConfig, device,
                init_fn: Optional[Callable] = None) -> History:
    """One mode of the example's ResNet on ``device``; ``init_fn(generator)``
    defaults to ``init_resnet`` on that device."""
    device = resolve_device(device)
    if init_fn is None:
        init_fn = lambda gen: init_resnet(gen, EXAMPLE, device)  # noqa: E731
    return run(cfg, init_fn, make_grad_fn(EXAMPLE),
               make_eval_fn(EXAMPLE, held_out_batch(EXAMPLE, device)),
               make_pipeline(EXAMPLE, device, cfg.steps_per_epoch),
               device=device)


def main(argv: Optional[list] = None) -> dict[str, History]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    print(f"{'mode':10s} {'final_acc':>9s} {'epoch_time':>10s} {'staleness':>9s}")
    out = {}
    for mode in MODES:
        cfg = example_config(mode, epochs=args.epochs, workers=args.workers,
                             clients=args.clients)
        h = run_example(cfg, args.device)
        print(f"{mode:10s} {h.metrics[-1]:9.3f} {h.epoch_time:9.1f}s "
              f"{h.mean_staleness:9.2f}")
        out[mode] = h
    return out


if __name__ == "__main__":
    main()
