"""Fused Elastic-SGD exchange kernels (paper eqs. (2)+(3)).

Replace, in ``repro/kernels/fused_elastic/fused_elastic.py``:

  elastic_exchange_flat     (:69)   one (w, w̃) pair -> both updates from
                                    the same difference:
                                    w' = w − α (w − w̃), w̃' = w̃ + α (w − w̃)
                                    (``core.elastic.elastic_exchange_packed``)
  elastic_client_flat       (:83)   eq. (3) only: w' = w − α (w − w̃), the
                                    client's local half when the server
                                    half runs in the PS tier (Elastic2)
  elastic_server_flat       (:97)   eq. (2) only: w̃' = w̃ + α (w − w̃), the
                                    KVStore's elastic rule (Elastic1)
  elastic_client_diff_flat  (:114)  eq. (3) and the raw f32 difference
                                    (w − w̃) in one pass: the difference is
                                    what the sharded cross-pod leg ring
                                    reduce-scatters
  elastic_center_flat       (:131)  eq. (2) on a device's 1/p center shard,
                                    fed the reduce-scattered Σ_c (w_c − w̃)
  elastic_exchange_flat_mc  (:151)  C stacked client replicas against one
                                    shared center:
                                    w_c' = w_c − α (w_c − w̃),
                                    w̃'  = w̃ + α Σ_c (w_c − w̃)

Bound on Hopper: HBM bytes. The one-pair exchange moves 16 B per f32
element (read w, w̃; write both), the client and server passes 12 B
(read w, w̃; write one output), the client-diff pass 16 B,
the center pass 12 B, the C-client pass (2C + 2)·4 B — each for a few
flops per element, far below the card's compute-to-bandwidth ratio.

Two routes. ``elastic_client_flat`` and ``elastic_server_flat`` are CUDA
C++ for ``sm_90a`` (``src/repro_torch/csrc/fused_elastic.cu``, built with
``nvcc`` at first use into ``build/cuda/`` and bound through ``ctypes``
by ``kernels/cuda_build``): the main path runs them on the whole packed
buffer, and they lost to ``torch.lerp`` by ~1 % as Triton passes, so they
were the first redesign for the card. One CTA per 4096 elements brings
its tiles of w and w̃ into shared memory with two 1-D bulk async copies
on one mbarrier, and 1024 threads compute and store them from registers;
the ragged last tile takes ordinary loads. On the H100 it runs at ~91 %
of the HBM bound, level with ``torch.lerp`` (0.3 % under it, timed in
turns; PERF.md): bulk copies buy parity, not more, and a persistent grid
that streamed tiles through a ring of them ran 3–5 % slower.

The other four are Triton: single fused elementwise passes, and for the
C-client kernel an elementwise pass plus a reduction over the C ≤ 8 rows
that each program carries in registers.
Each Triton program takes one ``BLOCK`` of the flat buffer and masks the
ragged tail (no padding copy); all math is f32 in registers and each
output is stored once in its own dtype. α is an f32 device scalar, so no
step waits on the host. A stacked ``(…, n)`` buffer (one row per
emulated device) is one launch over the whole contiguous buffer, as one
``pallas_call`` under ``vmap`` is in the reference.

Rounding, as the reference's compiled code rounds: eq. (3) in the
one-pair exchange, the client and client-diff passes and eq. (2) in the
one-pair exchange, the server and center passes are each ONE fused
multiply-add (``tl.fma``, ``__fmaf_rn`` in the CUDA kernel after
``__fsub_rn``; the plain versions form the exact product and
sum in f64 and round once) — XLA's CPU code contracts all of them,
interpreted or under ``jit``: the one-pair kernel's d = α (w − w̃) is
never rounded on its own, w' = fma(−α, w − w̃, w) and w̃' = fma(α,
w − w̃, w̃) — while the C-client
kernel rounds the product and the sum separately (it is built with
``enable_fp_fusion=False``). Its center sum runs over the rows in the
order c = 0, 1, …, C − 1, from 0.0, in the kernel and in its plain
version alike.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.common import on_cpu, triton

BLOCK = 4096
NUM_WARPS = 8

#: ``triton.language``, bound as a module global on the first build: the
#: kernels are compiled from this module's source and resolve ``tl`` in
#: its globals (Triton does not read closures)
tl = None


# -- plain versions: the CPU path and the card's reference ------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once, as a fused multiply-add: the f32
    product is exact in f64, and the f64 sum is rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def elastic_exchange_flat_plain(w: torch.Tensor, c: torch.Tensor,
                                alpha: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    a = alpha.reshape(())
    w32, c32 = w.float(), c.float()
    diff = w32 - c32
    return _fma(-a, diff, w32).to(w.dtype), _fma(a, diff, c32).to(c.dtype)


def elastic_client_flat_plain(w: torch.Tensor, c: torch.Tensor,
                              alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.reshape(())
    w32 = w.float()
    return _fma(-a, w32 - c.float(), w32).to(w.dtype)


def elastic_server_flat_plain(w: torch.Tensor, c: torch.Tensor,
                              alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.reshape(())
    c32 = c.float()
    return _fma(a, w.float() - c32, c32).to(c.dtype)


def elastic_client_diff_flat_plain(w: torch.Tensor, c: torch.Tensor,
                                   alpha: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    a = alpha.reshape(())
    w32 = w.float()
    diff = w32 - c.float()
    return _fma(-a, diff, w32).to(w.dtype), diff


def elastic_center_flat_plain(c: torch.Tensor, diff_sum: torch.Tensor,
                              alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.reshape(())
    return _fma(a, diff_sum.float(), c.float()).to(c.dtype)


def elastic_exchange_flat_mc_plain(w: torch.Tensor, c: torch.Tensor,
                                   alpha: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    a = alpha.reshape(())
    w32 = w.float()
    c32 = c.float()
    diff = w32 - c32
    acc = torch.zeros_like(c32)
    for row in diff:            # c = 0 … C-1, as the kernel sums
        acc = acc + row
    return (w32 - a * diff).to(w.dtype), (c32 + a * acc).to(c.dtype)


# -- Triton kernels ----------------------------------------------------------

@functools.cache
def _exchange_kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def exchange_kernel(alpha_ptr, w_ptr, c_ptr, w_out_ptr, c_out_ptr, n,
                        BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        alpha = tl.load(alpha_ptr)
        w = tl.load(w_ptr + offs, mask=mask).to(tl.float32)
        c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
        diff = w - c
        tl.store(w_out_ptr + offs,
                 tl.fma(-alpha, diff, w).to(w_out_ptr.dtype.element_ty),
                 mask=mask)                     # eq. (3)
        tl.store(c_out_ptr + offs,
                 tl.fma(alpha, diff, c).to(c_out_ptr.dtype.element_ty),
                 mask=mask)                     # eq. (2)

    return exchange_kernel


@functools.cache
def _client_diff_kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def client_diff_kernel(alpha_ptr, w_ptr, c_ptr, w_out_ptr, d_out_ptr, n,
                           BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        alpha = tl.load(alpha_ptr)
        w = tl.load(w_ptr + offs, mask=mask).to(tl.float32)
        c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
        diff = w - c
        tl.store(w_out_ptr + offs,
                 tl.fma(-alpha, diff, w).to(w_out_ptr.dtype.element_ty),
                 mask=mask)
        tl.store(d_out_ptr + offs, diff, mask=mask)

    return client_diff_kernel


@functools.cache
def _center_kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def center_kernel(alpha_ptr, c_ptr, ds_ptr, c_out_ptr, n,
                      BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        alpha = tl.load(alpha_ptr)
        c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
        ds = tl.load(ds_ptr + offs, mask=mask).to(tl.float32)
        tl.store(c_out_ptr + offs,
                 tl.fma(alpha, ds, c).to(c_out_ptr.dtype.element_ty),
                 mask=mask)

    return center_kernel


@functools.cache
def _mc_kernel():
    global tl
    tr = triton()
    import triton.language as tl

    @tr.jit
    def mc_kernel(alpha_ptr, w_ptr, c_ptr, w_out_ptr, c_out_ptr, n,
                  w_row_stride, C: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        alpha = tl.load(alpha_ptr)
        c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for r in tl.static_range(C):      # rows in order c = 0 … C-1
            row = r * w_row_stride
            w = tl.load(w_ptr + row + offs, mask=mask).to(tl.float32)
            diff = w - c
            tl.store(w_out_ptr + row + offs,
                     (w - alpha * diff).to(w_out_ptr.dtype.element_ty),
                     mask=mask)
            acc = acc + diff
        tl.store(c_out_ptr + offs,
                 (c + alpha * acc).to(c_out_ptr.dtype.element_ty), mask=mask)

    return mc_kernel


# -- wrappers ----------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_floating_point():
        raise ValueError(f"{name}: dtype {t.dtype} is not floating")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_alpha(alpha: torch.Tensor) -> None:
    if alpha.numel() != 1 or alpha.dtype != torch.float32:
        raise ValueError(f"alpha: want one float32 value, got shape "
                         f"{tuple(alpha.shape)} {alpha.dtype}")


def _one_side(w: torch.Tensor, c: torch.Tensor, alpha: torch.Tensor,
              server: bool) -> torch.Tensor:
    """Launch ``csrc/fused_elastic.cu``'s eq. (2) (``server``) or eq. (3)
    pass on CUDA tensors: checks, then one launch on the current stream;
    raises on a refused launch."""
    _check("w", w, w.shape)
    _check("c", c, w.shape)
    _check_alpha(alpha)
    for name, t in (("w", w), ("c", c)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: dtype {t.dtype}, want float32 or bfloat16")
    out = torch.empty_like(c if server else w)
    for name, t in (("w", w), ("c", c), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data_ptr not 16-byte aligned (the bulk "
                             "copies need it; a fresh tensor is)")
    n = w.numel()
    if n:
        lib = cuda_build.load_library("fused_elastic")
        fn = lib.elastic_server_flat_cuda if server else lib.elastic_client_flat_cuda
        with torch.cuda.device(w.device):   # the library launches on the current one
            err = fn(alpha.data_ptr(), w.data_ptr(), c.data_ptr(), out.data_ptr(), n,
                     int(w.dtype == torch.bfloat16), int(c.dtype == torch.bfloat16),
                     torch.cuda.current_stream(w.device).cuda_stream)
        cuda_build.check(lib, err, f"elastic_{'server' if server else 'client'}_flat")
    return out


def elastic_exchange_flat(w: torch.Tensor, c: torch.Tensor,
                          alpha: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eqs. (3) and (2) in ONE pass over equal-shape contiguous ``w``,
    ``c``: -> ``(new w in w's dtype, new w̃ in c's dtype)``, both from the
    same difference. ``alpha`` is one f32 value on the same device. A CPU
    tensor takes the plain version; a CUDA tensor launches the Triton
    kernel."""
    if on_cpu(w, c, alpha):
        return elastic_exchange_flat_plain(w, c, alpha)
    _check("w", w, w.shape)
    _check("c", c, w.shape)
    _check_alpha(alpha)
    w_out, c_out = torch.empty_like(w), torch.empty_like(c)
    n = w.numel()
    if n:
        grid = (triton().cdiv(n, BLOCK),)
        _exchange_kernel()[grid](alpha, w, c, w_out, c_out, n, BLOCK=BLOCK,
                                 num_warps=NUM_WARPS)
        elastic_exchange_flat.launches += 1
    return w_out, c_out


def elastic_client_flat(w: torch.Tensor, c: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """Eq. (3) only, for equal-shape contiguous ``w``, ``c``: -> new w in
    w's dtype, nothing else written. ``w`` and ``c`` are f32 or bf16,
    their data 16-byte aligned; ``alpha`` is one f32 value on the same
    device. A CPU tensor takes the plain version; a CUDA tensor launches
    the CUDA kernel of ``csrc/fused_elastic.cu``."""
    if on_cpu(w, c, alpha):
        return elastic_client_flat_plain(w, c, alpha)
    out = _one_side(w, c, alpha, server=False)
    if w.numel():
        elastic_client_flat.launches += 1
    return out


def elastic_server_flat(w: torch.Tensor, c: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """Eq. (2) only, for equal-shape contiguous ``w``, ``c``: -> new w̃ in
    c's dtype, nothing else written, under ``elastic_client_flat``'s
    rules. A CPU tensor takes the plain version; a CUDA tensor launches
    the CUDA kernel of ``csrc/fused_elastic.cu``."""
    if on_cpu(w, c, alpha):
        return elastic_server_flat_plain(w, c, alpha)
    out = _one_side(w, c, alpha, server=True)
    if w.numel():
        elastic_server_flat.launches += 1
    return out


def elastic_client_diff_flat(w: torch.Tensor, c: torch.Tensor,
                             alpha: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (3) plus the raw f32 difference in ONE pass over equal-shape
    contiguous ``w``, ``c`` (flat, or stacked ``(…, n)``): returns
    ``(new_w in w's dtype, (w − w̃) in f32)``. ``alpha`` is one f32 value
    on the same device. A CPU tensor takes the plain version; a CUDA
    tensor launches the Triton kernel."""
    if on_cpu(w, c, alpha):
        return elastic_client_diff_flat_plain(w, c, alpha)
    _check("w", w, w.shape)
    _check("c", c, w.shape)
    _check_alpha(alpha)
    w_out = torch.empty_like(w)
    d_out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    n = w.numel()
    if n:
        grid = (triton().cdiv(n, BLOCK),)
        _client_diff_kernel()[grid](alpha, w, c, w_out, d_out, n, BLOCK=BLOCK,
                                    num_warps=NUM_WARPS)
        elastic_client_diff_flat.launches += 1
    return w_out, d_out


def elastic_center_flat(c: torch.Tensor, diff_sum: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """Eq. (2) on a center shard: ``c + α·diff_sum`` in c's dtype, for
    equal-shape contiguous ``c`` and ``diff_sum`` (flat or stacked). A
    CPU tensor takes the plain version; a CUDA tensor launches the Triton
    kernel."""
    if on_cpu(c, diff_sum, alpha):
        return elastic_center_flat_plain(c, diff_sum, alpha)
    _check("c", c, c.shape)
    _check("diff_sum", diff_sum, c.shape)
    _check_alpha(alpha)
    c_out = torch.empty_like(c)
    n = c.numel()
    if n:
        grid = (triton().cdiv(n, BLOCK),)
        _center_kernel()[grid](alpha, c, diff_sum, c_out, n, BLOCK=BLOCK,
                               num_warps=NUM_WARPS)
        elastic_center_flat.launches += 1
    return c_out


def elastic_exchange_flat_mc(w: torch.Tensor, c: torch.Tensor,
                             alpha: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass for the whole multi-client exchange: ``w`` is ``(C, n)``
    stacked client replicas, ``c`` the ``(n,)`` shared center. Every
    client's eq. (3) update and the summed eq. (2) center move come from
    the same pre-update differences. Returns ``(new_w (C, n), new_c
    (n,))``. A CPU tensor takes the plain version; a CUDA tensor launches
    the Triton kernel."""
    if on_cpu(w, c, alpha):
        return elastic_exchange_flat_mc_plain(w, c, alpha)
    if w.dim() != 2 or w.shape[0] < 1:
        raise ValueError(f"w: want (C, n) with C >= 1, got {tuple(w.shape)}")
    C, n = w.shape
    _check("w", w, (C, n))
    _check("c", c, (n,))
    _check_alpha(alpha)
    w_out, c_out = torch.empty_like(w), torch.empty_like(c)
    if n:
        grid = (triton().cdiv(n, BLOCK),)
        _mc_kernel()[grid](alpha, w, c, w_out, c_out, n, w.stride(0), C=C,
                           BLOCK=BLOCK, num_warps=NUM_WARPS,
                           enable_fp_fusion=False)
        elastic_exchange_flat_mc.launches += 1
    return w_out, c_out


elastic_exchange_flat.launches = 0
elastic_client_flat.launches = 0
elastic_server_flat.launches = 0
elastic_client_diff_flat.launches = 0
elastic_center_flat.launches = 0
elastic_exchange_flat_mc.launches = 0
