"""Fused flat AdaGrad and AdamW updates.

Replace ``repro/kernels/fused_optim/fused_optim.py:adagrad_flat`` and
``:adamw_flat`` (the Pallas ``_adagrad_kernel`` and ``_adamw_kernel``).

  AdaGrad  s' = s + g²;  p' = p − lr·g/(√s' + eps)
  AdamW    m' = b1·m + (1−b1)·g;  v' = b2·v + (1−b2)·g·g;
           p' = p − lr·((m'/c1)/(√(v'/c2) + eps) + wd·p)

with c1 = 1 − b1^t and c2 = 1 − b2^t for the post-increment step count t,
computed by the caller ON THE DEVICE and read here from the f32 ``hp``
vector, so the step needs no host sync.

Bound on Hopper: HBM bytes. With f32 streams AdaGrad moves 20 B per
element (3 reads, 2 writes) and AdamW 28 B (p, m, v, g read; p, m, v
written) for a handful of flops — far below the compute-to-bandwidth
ratio. The design is one masked, vectorised pass over a 1-D grid, one
``BLOCK`` per program, the tail masked (no padding copy), f32 math in
registers, each output stored once in its own dtype (f32 or bf16 state).
AdamW's ``(2, n)`` m/v buffer is read and written whole through its row
stride, never re-stacked; stacked rows (one per emulated device or
client: ``(R, n)`` params, ``(R, 2, n)`` m/v) are one launch over a 2-D
grid (blocks × rows) sharing one hp vector, since every member steps
together. Square roots and divisions are the IEEE round-to-nearest forms (``sqrt_rn``, ``div_rn``): plain ``tl.sqrt`` and
``/`` lower to approximate instructions.

Why Triton and not CUDA C++: each update is one elementwise pass, a pure
stream. On an NVIDIA H100 80GB HBM3 at 700 W every 12 B/element stream
measured stopped at 91–92 % of the 3.35 TB/s bound whatever the load
path — 1-D bulk async copies (``csrc/fused_elastic.cu``), vector loads,
Triton passes and PyTorch's own ``torch.lerp`` / ``torch.add``
(``kernels/fused_elastic/sweep.py`` and ``chip_smoke.py``) — and these
passes reach ~91 % of their bounds and beat ``torch._fused_adamw_`` /
``torch._fused_adagrad_`` on the same card (``chip_smoke.py``, PERF.md).
A hand-written CUDA C++ stream would move the same bytes no faster; only
moving fewer bytes would.
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


# -- plain versions: the CPU path and the card's reference ------------------

def adagrad_flat_plain(p: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                       hp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    lr, eps = hp[0], hp[1]
    g32 = g.float()
    s32 = s.float() + g32 * g32
    p32 = p.float() - lr * g32 / (torch.sqrt(s32) + eps)
    return p32.to(p.dtype), s32.to(s.dtype)


def adamw_flat_plain(p: torch.Tensor, mv: torch.Tensor, g: torch.Tensor,
                     hp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    lr, b1, b2, eps, wd, c1, c2 = hp.unbind()
    g32 = g.float()
    m32 = b1 * mv[..., 0, :].float() + (1.0 - b1) * g32
    v32 = b2 * mv[..., 1, :].float() + (1.0 - b2) * g32 * g32
    p32 = p.float()
    upd = (m32 / c1) / (torch.sqrt(v32 / c2) + eps) + wd * p32
    return ((p32 - lr * upd).to(p.dtype),
            torch.stack([m32, v32], -2).to(mv.dtype))


# -- Triton kernels ----------------------------------------------------------

@functools.cache
def _adagrad_kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def adagrad_kernel(hp_ptr, p_ptr, s_ptr, g_ptr, p_out_ptr, s_out_ptr, n,
                       BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        lr = tl.load(hp_ptr)
        eps = tl.load(hp_ptr + 1)
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        s_new = tl.load(s_ptr + offs, mask=mask).to(tl.float32) + g * g
        tl.store(s_out_ptr + offs, s_new.to(s_out_ptr.dtype.element_ty),
                 mask=mask)
        p = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
        p_new = p - tl.div_rn(lr * g, tl.sqrt_rn(s_new) + eps)
        tl.store(p_out_ptr + offs, p_new.to(p_out_ptr.dtype.element_ty),
                 mask=mask)

    return adagrad_kernel


@functools.cache
def _adamw_kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def adamw_kernel(hp_ptr, p_ptr, mv_ptr, g_ptr, p_out_ptr, mv_out_ptr, n,
                     BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        row = tl.program_id(1).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        p_ptr += row * n
        g_ptr += row * n
        p_out_ptr += row * n
        mv_ptr += row * 2 * n
        mv_out_ptr += row * 2 * n
        lr = tl.load(hp_ptr)
        b1 = tl.load(hp_ptr + 1)
        b2 = tl.load(hp_ptr + 2)
        eps = tl.load(hp_ptr + 3)
        wd = tl.load(hp_ptr + 4)
        c1 = tl.load(hp_ptr + 5)
        c2 = tl.load(hp_ptr + 6)
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        m = tl.load(mv_ptr + offs, mask=mask).to(tl.float32)
        v = tl.load(mv_ptr + n + offs, mask=mask).to(tl.float32)
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        out_ty = mv_out_ptr.dtype.element_ty
        tl.store(mv_out_ptr + offs, m_new.to(out_ty), mask=mask)
        tl.store(mv_out_ptr + n + offs, v_new.to(out_ty), mask=mask)
        p = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
        denom = tl.sqrt_rn(tl.div_rn(v_new, c2)) + eps
        upd = tl.div_rn(tl.div_rn(m_new, c1), denom) + wd * p
        tl.store(p_out_ptr + offs,
                 (p - lr * upd).to(p_out_ptr.dtype.element_ty), mask=mask)

    return adamw_kernel


# -- wrappers ----------------------------------------------------------------

def _check_hp(hp: torch.Tensor, k: int) -> None:
    check_flat("hp", hp, k)
    if hp.dtype != torch.float32:
        raise ValueError(f"hp: dtype {hp.dtype}, want float32")


def adagrad_flat(p: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                 hp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused AdaGrad step on flat ``(n,)`` streams; ``hp`` is the f32
    ``(lr, eps)`` vector. Returns new ``(p', s')``. CPU tensors take the
    plain version; CUDA tensors launch the Triton kernel."""
    if on_cpu(p, s, g, hp):
        return adagrad_flat_plain(p, s, g, hp)
    n = p.shape[0]
    for name, t in (("p", p), ("s", s), ("g", g)):
        check_flat(name, t, n)
    _check_hp(hp, 2)
    p_out, s_out = torch.empty_like(p), torch.empty_like(s)
    if n:
        grid = (triton().cdiv(n, BLOCK),)
        _adagrad_kernel()[grid](hp, p, s, g, p_out, s_out, n, BLOCK=BLOCK,
                                num_warps=NUM_WARPS)
        adagrad_flat.launches += 1
    return p_out, s_out


def adamw_flat(p: torch.Tensor, mv: torch.Tensor, g: torch.Tensor,
               hp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused AdamW step on a flat ``(n,)`` param/grad pair and the
    ``(2, n)`` stacked m/v buffer, carried whole in and out. ``hp`` is
    the f32 ``(lr, b1, b2, eps, wd, c1, c2)`` vector. Stacked rows —
    ``(R, n)`` p and g, ``(R, 2, n)`` mv — update in one launch under
    the one ``hp``. Returns new ``(p', mv')``. CPU tensors take the plain
    version; CUDA tensors launch the Triton kernel."""
    if on_cpu(p, mv, g, hp):
        return adamw_flat_plain(p, mv, g, hp)
    if p.dim() not in (1, 2):
        raise ValueError(f"p: want (n,) or (R, n), got {tuple(p.shape)}")
    rows = p.shape[0] if p.dim() == 2 else 0
    lead = (rows,) if rows else ()
    n = p.shape[-1]
    for name, t, shape in (("p", p, lead + (n,)), ("g", g, lead + (n,)),
                           ("mv", mv, lead + (2, n)), ("hp", hp, (7,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if not t.is_floating_point():
            raise ValueError(f"{name}: dtype {t.dtype} is not floating")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if hp.dtype != torch.float32:
        raise ValueError(f"hp: dtype {hp.dtype}, want float32")
    p_out, mv_out = torch.empty_like(p), torch.empty_like(mv)
    if n and p.numel():
        grid = (triton().cdiv(n, BLOCK), max(rows, 1))
        _adamw_kernel()[grid](hp, p, mv, g, p_out, mv_out, n, BLOCK=BLOCK,
                              num_warps=NUM_WARPS)
        adamw_flat.launches += 1
    return p_out, mv_out


adagrad_flat.launches = 0
adamw_flat.launches = 0
