"""Device timing of a kernel against its one-call PyTorch yardstick, in
turns on one card.

``interleaved_ms`` runs ``rounds`` rounds of (library × reps, kernel ×
reps, kernel × reps, library × reps), each block between two CUDA events,
so drift in clocks, power or neighbours falls on both alike. Each block
gives one per-call time; the result is the median and the min–max of
each side's 2 × ``rounds`` blocks. Needs a CUDA device.
"""
from __future__ import annotations

import statistics

import torch


def _block_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _summary(times: list[float]) -> dict:
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "blocks": len(times)}


def interleaved_ms(kernel_fn, library_fn, rounds: int = 7, reps: int = 10,
                   warmup: int = 2) -> dict:
    """``{"kernel": {median, min, max, blocks}, "library": {...}}``, in ms
    per call."""
    for _ in range(warmup):
        kernel_fn()
        library_fn()
    torch.cuda.synchronize()
    kernel, library = [], []
    for _ in range(rounds):
        library.append(_block_ms(library_fn, reps))
        kernel.append(_block_ms(kernel_fn, reps))
        kernel.append(_block_ms(kernel_fn, reps))
        library.append(_block_ms(library_fn, reps))
    return {"kernel": _summary(kernel), "library": _summary(library)}


def spread(s: dict) -> str:
    """``median [min–max]`` of one side, in ms."""
    return f"{s['median']:.4f} [{s['min']:.4f}–{s['max']:.4f}]"
