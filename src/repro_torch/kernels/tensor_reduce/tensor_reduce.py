"""Grouped-vector reduction: the paper's node-tensor reduce (§7.3).

Replaces ``repro/kernels/tensor_reduce/tensor_reduce.py:group_reduce_flat``
(the Pallas ``_group_reduce_kernel``): a stacked group ``(G, N)`` of one
node's device values -> their sum ``(N,)``, accumulated in f32 and stored
in the input dtype. ``core/kvstore.local_reduce`` runs it, leaf by leaf,
on a list push of several device values.

Rounding, as the reference computes: the sum runs over the G rows in
member order from 0.0, ``((0 + x_0) + x_1) + …``, each add rounded to
f32 (the reference's interpret-mode reduction gives exactly that
sequential sum), and the result is rounded once to the input dtype. The
kernel and the plain version add in the same order, so they agree bit
for bit.

Bound on Hopper: HBM bytes. Each output value reads G inputs and writes
one, for G − 1 adds: (G + 1) × itemsize bytes per value against G flops,
far below the card's compute-to-bandwidth ratio, so CUDA C++ would buy
nothing here and the kernel is Triton: a reduction over G ≤ 16 rows that
each program carries in registers. Each program takes one ``BLOCK`` of N,
loads the G rows of that block in order and accumulates them in f32; the
ragged tail of N is masked (no padded copy of the group).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.common import on_cpu, triton

BLOCK = 4096
NUM_WARPS = 8
#: the largest group the kernel unrolls (the rows are a static loop)
MAX_GROUP = 16

#: ``triton.language``, bound as a module global on the first build: the
#: kernel is compiled from this module's source and resolves ``tl`` in
#: its globals (Triton does not read closures)
tl = None


def group_reduce_flat_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the card's reference."""
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for row in x:                 # members in order, as the kernel sums
        acc = acc + row.float()
    return acc.to(x.dtype)


@functools.cache
def _kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def group_reduce_kernel(x_ptr, out_ptr, n, G: tl.constexpr,
                            BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for r in tl.static_range(G):      # members in order, g = 0 … G-1
            acc = acc + tl.load(x_ptr + r * n + offs, mask=mask).to(tl.float32)
        tl.store(out_ptr + offs, acc.to(out_ptr.dtype.element_ty), mask=mask)

    return group_reduce_kernel


def group_reduce_flat(x: torch.Tensor) -> torch.Tensor:
    """``(G, N)`` contiguous float -> ``(N,)``, the f32-accumulated sum
    over G in the input dtype. A CPU tensor takes the plain version; a
    CUDA tensor launches the Triton kernel."""
    if on_cpu(x):
        return group_reduce_flat_plain(x)
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_GROUP:
        raise ValueError(f"x: want (G, N) with 1 <= G <= {MAX_GROUP}, got "
                         f"{tuple(x.shape)}")
    if not x.is_floating_point():
        raise ValueError(f"x: dtype {x.dtype} is not floating")
    if not x.is_contiguous():
        raise ValueError("x: not contiguous")
    G, n = x.shape
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    if n:
        _kernel()[(triton().cdiv(n, BLOCK),)](x, out, n, G=G, BLOCK=BLOCK,
                                              num_warps=NUM_WARPS)
        group_reduce_flat.launches += 1
    return out


group_reduce_flat.launches = 0
