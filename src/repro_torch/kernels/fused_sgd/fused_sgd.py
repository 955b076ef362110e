"""Fused momentum-SGD update: v' = µv + g; p' = p − lr·v'.

Replaces ``repro/kernels/fused_sgd/fused_sgd.py:sgd_momentum_flat`` (the
Pallas ``_sgd_kernel``). Unfused, the update is two passes over the whole
model; fused it reads (p, v, g) once and writes (p', v') once.

Bound on Hopper: HBM bytes. With f32 streams that is 20 B per element
(3 reads + 2 writes of 4 B) against 4 flops, ~0.2 flop/B — far below the
card's compute-to-bandwidth ratio. The design does the one thing that
moves that bound: a single masked, vectorised pass over a 1-D grid, one
``BLOCK`` per program, the ragged tail masked (no padding copy), all math
in f32 in registers, each output stored once in its own dtype. The
hyperparameters come from a small f32 device tensor, so the step needs no
host sync.

Why Triton and not CUDA C++: the update is one elementwise pass, a pure
stream. On an NVIDIA H100 80GB HBM3 at 700 W every 12 B/element stream
measured stopped at 91–92 % of the 3.35 TB/s bound whatever the load
path — 1-D bulk async copies (``csrc/fused_elastic.cu``), vector loads,
Triton passes and PyTorch's own ``torch.lerp`` / ``torch.add``
(``kernels/fused_elastic/sweep.py`` and ``chip_smoke.py``) — and this pass
reaches ~91 % of its bound and beats ``torch._fused_sgd_`` on the same
card (``chip_smoke.py``, PERF.md). A hand-written CUDA C++ stream would
move the same bytes no faster; only moving fewer bytes would.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.common import check_flat, on_cpu, triton

BLOCK = 4096
NUM_WARPS = 8

#: ``triton.language``, bound as a module global on the first build: the
#: kernels are compiled from this module's source and resolve ``tl`` in
#: its globals (Triton does not read closures)
tl = None


def sgd_momentum_flat_plain(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                            hp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the CPU path and the card's reference."""
    lr, mu = hp[0], hp[1]
    v32 = mu * v.float() + g.float()
    p32 = p.float() - lr * v32
    return p32.to(p.dtype), v32.to(v.dtype)


@functools.cache
def _kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def sgd_kernel(hp_ptr, p_ptr, v_ptr, g_ptr, p_out_ptr, v_out_ptr, n,
                   BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        lr = tl.load(hp_ptr)
        mu = tl.load(hp_ptr + 1)
        v = tl.load(v_ptr + offs, mask=mask).to(tl.float32)
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        p = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
        v_new = mu * v + g
        tl.store(v_out_ptr + offs, v_new.to(v_out_ptr.dtype.element_ty),
                 mask=mask)
        tl.store(p_out_ptr + offs,
                 (p - lr * v_new).to(p_out_ptr.dtype.element_ty), mask=mask)

    return sgd_kernel


def sgd_momentum_flat(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                      hp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused momentum-SGD step on flat ``(n,)`` streams; ``hp`` is the
    f32 ``(lr, µ)`` vector on the same device. Returns new
    ``(p', v')`` tensors in the dtypes of ``p`` and ``v``. A CPU tensor
    takes the plain version; a CUDA tensor launches the Triton kernel."""
    if on_cpu(p, v, g, hp):
        return sgd_momentum_flat_plain(p, v, g, hp)
    n = p.shape[0]
    for name, t in (("p", p), ("v", v), ("g", g)):
        check_flat(name, t, n)
    check_flat("hp", hp, 2)
    if hp.dtype != torch.float32:
        raise ValueError(f"hp: dtype {hp.dtype}, want float32")
    p_out, v_out = torch.empty_like(p), torch.empty_like(v)
    if n:
        grid = (triton().cdiv(n, BLOCK),)
        _kernel()[grid](hp, p, v, g, p_out, v_out, n, BLOCK=BLOCK,
                        num_warps=NUM_WARPS)
        sgd_momentum_flat.launches += 1
    return p_out, v_out


sgd_momentum_flat.launches = 0
