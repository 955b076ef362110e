"""The shared training problem for multi-process runs
(``repro/net/problem.py``).

Every process (and the in-process reference run) must build the SAME
init/grad/eval/pipeline functions for the equality gates to mean
anything, so they live here — logistic regression on the synthetic image
pipeline (8 px, 10 classes), the problem the reference's transport tier
trains. ``init_fn`` takes a CPU ``torch.Generator``, as
``core.algorithms.run`` passes one; ``grad_fn(params, batch) -> (loss,
grads)``; the params, the batches and the eval batch live on ``device``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch


class Problem(NamedTuple):
    name: str
    init_fn: Callable[[torch.Generator], Any]
    grad_fn: Callable[[Any, Any], Any]
    eval_fn: Callable[[Any], float]
    make_pipeline: Callable[[int], Any]


def build_problem(name: str = "logreg8", device="cuda") -> Problem:
    from repro_torch.launch.train import resolve_device

    return _build(name, str(resolve_device(device)))


@functools.lru_cache(maxsize=None)
def _build(name: str, device: str) -> Problem:
    if name != "logreg8":
        raise ValueError(f"unknown problem {name!r} (have: logreg8)")

    from repro_torch.data.pipeline import DataConfig, ImagePipeline

    D, NCLS = 8 * 8 * 3, 10

    def init_fn(gen: torch.Generator):
        return {"w": (torch.randn((D, NCLS), generator=gen) * 0.01).to(device),
                "b": torch.zeros((NCLS,), device=device)}

    def _logits(params, images):
        return images.reshape(images.shape[0], -1) @ params["w"] + params["b"]

    def grad_fn(params, batch):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = _logits(p, batch["images"])
        gold = logits.gather(1, batch["labels"].long()[:, None])[:, 0]
        loss = (torch.logsumexp(logits, -1) - gold).mean()
        gw, gb = torch.autograd.grad(loss, [p["w"], p["b"]])
        return loss.detach(), {"w": gw, "b": gb}

    test_batch = ImagePipeline(
        DataConfig(seed=0, batch_size=256, steps_per_epoch=1, shard=12345),
        image_size=8, device=device).batch_at(999, 0)

    @torch.no_grad()
    def eval_fn(params) -> float:
        pred = _logits(params, test_batch["images"]).argmax(-1)
        return float((pred == test_batch["labels"]).float().mean())

    def make_pipeline(w):
        return ImagePipeline(
            DataConfig(seed=0, batch_size=16, steps_per_epoch=10, shard=w),
            image_size=8, device=device)

    return Problem(name, init_fn, grad_fn, eval_fn, make_pipeline)
