"""Shared kernel plumbing: layout constants, dispatch and the Triton build.

``LANE`` and ``SUBLANE`` are *layout* constants here, not GPU tile sizes:
the FlatBuffer aligns leaf offsets and shard chunks to them
(``core/flatbuf.py``), so the port's buffer layout is byte-for-byte the
reference's.

Dispatch is on the tensor's device alone: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the hand-written kernel
(which is built on first use or raises). There is no override.
"""
from __future__ import annotations

import functools
import os
from pathlib import Path

import torch

LANE = 128          # leaf offsets and shard chunks align to this
SUBLANE = 8         # the buffer length is a multiple of LANE * SUBLANE

#: where Triton caches what it compiles from this checkout's sources
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (-> plain version); False
    when every one lies on one CUDA device (-> kernel). Anything else
    raises: the kernels take no mixed-device arguments."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


@functools.cache
def triton():
    """Import Triton with its cache pointed into ``build/`` (first call
    only). Kernels are compiled from the repo's sources at first launch."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton as _triton

    return _triton


def check_flat(name: str, t: torch.Tensor, n: int, rows: int = 0) -> None:
    """Raise unless ``t`` is a contiguous floating ``(n,)`` (or
    ``(rows, n)``) tensor — the only layout the flat kernels take."""
    want = (rows, n) if rows else (n,)
    if tuple(t.shape) != want:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want}")
    if not t.is_floating_point():
        raise ValueError(f"{name}: dtype {t.dtype} is not floating")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
