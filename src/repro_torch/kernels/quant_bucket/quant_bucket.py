"""The int8 codecs: the per-hop plain form and the streaming kernels.

Ports ``repro/kernels/quant_bucket/quant_bucket.py``:

  quantize_flat              (:56)         the QBLOCK = 1024 PS-push codec,
  dequantize_flat            (:83)         one f32 scale per 1024 values:
                                           the per-leaf compress path
                                           (``ops.compress`` /
                                           ``decompress``), hand-written
                                           Triton kernels
  wire_encode / wire_decode  (:120, :141)  the per-hop codec a quantized
                                           ring hop runs; the reference
                                           writes it in plain ``jnp`` so
                                           XLA fuses it into each hop, and
                                           plain PyTorch is its faithful
                                           counterpart here
  quantize_wire              (:168)        the streaming pair for the
  dequantize_wire            (:199)        hop-free one-shot wire: the
                                           packed PS push
                                           (``core.elastic.wire_packed``),
                                           hand-written Triton kernels

Exactness, as the reference's code computes: the codes are
``round(x / scale)`` clipped to ±127 — a true division, never a
multiplication by the reciprocal, rounding half to even as ``jnp.round``
does. The scale is ``max(absmax, 1e-12) / 127`` in the per-hop codec, a
true division as the reference's op-by-op ``wire_encode`` makes it; in
the streaming pair and the QBLOCK pair it is ``max(absmax, 1e-12) ×
f32(1/127)``, because XLA compiles the division by the constant 127 in
the reference's ``quantize_wire`` and ``quantize_flat`` (interpreted or
not, called directly or under the jitted ``ops.compress``) into that
multiplication, which moves about 4 % of the scales by one ulp. So the
int8 codes and the scales of every form equal the reference's bit for
bit, on the CPU and on the card.

**The streaming kernels.** Bound on Hopper: HBM bytes. ``quantize_wire``
reads 4 B and writes 1 + 4/128 B per value for two divisions, a
128-wide max and a rounding; ``dequantize_wire`` moves the same bytes
the other way for one multiply. Both sit far below the card's
compute-to-bandwidth ratio, so a hand-scheduled CUDA C++ kernel buys
nothing over Triton here. Each program takes one tile of
``WIRE_TILE_ROWS`` = 64 buckets × 128 values as a (64, 128) block: the
per-bucket absmax is a row reduction in registers, and every value is
read once and written once. The input's ragged tail is masked (loaded
as zeros), so no padded copy of ``x`` is made, yet the stored outputs
keep the reference's shapes: codes ``(n_pad,)`` and scales
``(n_pad/128,)`` with n_pad rounded up to whole tiles, the pad buckets
holding code 0 and scale ``1e-12/127`` exactly as the reference's
zero padding gives them. The division ``x / scale`` is ``tl.div_rn``
(Triton's ``/`` on f32 is not IEEE-rounded), the scale multiplier is the
f32 argument ``RECIP`` = f32(1/127), and the rounding is libdevice
``rint`` (half to even); codes are clamped to ±127 before the int8 cast.

**The QBLOCK kernels** take one leaf at a time (the reference's per-leaf
``compress``): ``quantize_flat`` reads ``(n,)`` values and writes
unpadded ``(n,)`` codes and ``(⌈n/1024⌉,)`` scales, the last block's
absmax taken over its real values (the masked tail loads zeros, as the
reference's zero padding gives it); ``dequantize_flat`` reads the codes
and scales back into ``n`` values of the requested dtype. Each program
takes ``QBLOCK_ROWS`` = 8 blocks as an (8, 1024) tile, the per-block
absmax a row reduction in registers: the streaming pair's bound and
arithmetic (``div_rn``, ``rint``, ``RECIP``, the clamp), with 4 bytes of
scale per 1024 values in place of per 128. Most of a model's leaves hold
under one block, so the push of a whole tree is bound by its one launch
per leaf, not by HBM.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import ceil_div, on_cpu, triton

#: values per int8 scale of the per-leaf PS-push codec
QBLOCK = 1024
#: QBLOCK blocks per program of the per-leaf codec (8 × 1024 values)
QBLOCK_ROWS = 8
#: values per int8 scale group on the wire
WIRE_BLOCK = 128
#: buckets per streaming tile (64 × 128 = 8,192 values)
WIRE_TILE_ROWS = 64
WIRE_TILE = WIRE_TILE_ROWS * WIRE_BLOCK
NUM_WARPS = 8
#: f32(1/127): the streaming codec's scale multiplier (see above)
RECIP_127 = float(torch.tensor(1.0) / torch.tensor(127.0))

#: ``triton.language`` and its libdevice, bound as module globals on the
#: first build: the kernels are compiled from this module's source and
#: resolve both in its globals (Triton does not read closures)
tl = None
libdevice = None


def wire_nbytes(n: int) -> int:
    """Wire bytes of n f32 values in the int8 wire form (codes + scales)."""
    return n + -(-n // WIRE_BLOCK) * 4


def wire_padded(n: int) -> int:
    """The streaming codec's padded length: n rounded up to whole tiles."""
    return ceil_div(n, WIRE_TILE) * WIRE_TILE


def wire_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(…, n)`` float -> (codes ``(…, n_pad)`` int8, scales
    ``(…, n_pad/128)`` f32). Padding to whole WIRE_BLOCK buckets is zeros,
    which never raise a bucket's absmax; an all-zero bucket has scale
    ~7.9e-15 and decodes to exactly 0.0."""
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    xf = x.float()
    pad = (-n) % WIRE_BLOCK
    if pad:
        xf = F.pad(xf, (0, pad))
    xb = xf.reshape(lead + (-1, WIRE_BLOCK))
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    # a device tensor divisor: CUDA divides by a CPU scalar through its
    # reciprocal, which would move the scales off the reference's
    scale = torch.clamp(absmax, min=1e-12) / absmax.new_full((), 127.0)
    codes = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return codes.reshape(lead + (-1,)), scale[..., 0]


def wire_decode(codes: torch.Tensor, scales: torch.Tensor,
                n: int | None = None) -> torch.Tensor:
    """Inverse of ``wire_encode``: -> ``(…, n)`` f32 (``n`` trims the
    encoder's bucket padding)."""
    lead = tuple(codes.shape[:-1])
    out = (codes.reshape(lead + (-1, WIRE_BLOCK)).float()
           * scales.unsqueeze(-1)).reshape(lead + (-1,))
    return out if n is None else out[..., :n]


# -- plain versions of the kernels: the CPU path and the card's reference ----

def quantize_flat_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-leaf codec on ``x`` zero-padded to whole QBLOCK blocks, the
    scale multiplied by f32(1/127): -> (codes ``(n,)``, scales
    ``(⌈n/1024⌉,)``)."""
    n = x.shape[0]
    xb = F.pad(x.float(), (0, ceil_div(n, QBLOCK) * QBLOCK - n)).reshape(-1, QBLOCK)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) * absmax.new_full((), RECIP_127)
    codes = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return codes.reshape(-1)[:n], scale[:, 0]


def dequantize_flat_plain(codes: torch.Tensor, scales: torch.Tensor, n: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    cp = F.pad(codes[:n], (0, ceil_div(n, QBLOCK) * QBLOCK - n))
    out = cp.reshape(-1, QBLOCK).float() * scales[:ceil_div(n, QBLOCK), None]
    return out.reshape(-1)[:n].to(dtype)


def quantize_wire_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-hop codec's bucket math on ``x`` zero-padded to whole
    tiles, with the scale multiplied by f32(1/127)."""
    n = x.shape[-1]
    xb = F.pad(x.float(), (0, wire_padded(n) - n)).reshape(-1, WIRE_BLOCK)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) * absmax.new_full((), RECIP_127)
    codes = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return codes.reshape(-1), scale[:, 0]


def dequantize_wire_plain(codes: torch.Tensor, scales: torch.Tensor, n: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return wire_decode(codes, scales, n).to(dtype)


# -- Triton kernels ----------------------------------------------------------

def _bind_triton():
    global tl, libdevice
    tr = triton()
    import triton.language as tl
    from triton.language.extra import libdevice
    return tr


@functools.cache
def _quantize_kernel():
    tr = _bind_triton()

    @tr.jit
    def quantize_wire_kernel(x_ptr, codes_ptr, scales_ptr, n, RECIP,
                             ROWS: tl.constexpr, BLOCK: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        offs = rows[:, None] * BLOCK + tl.arange(0, BLOCK)[None, :]
        x = tl.load(x_ptr + offs, mask=offs < n, other=0.0).to(tl.float32)
        absmax = tl.max(tl.abs(x), axis=1)
        scale = tl.maximum(absmax, 1e-12) * RECIP
        q = libdevice.rint(
            tl.div_rn(x, tl.broadcast_to(scale[:, None], (ROWS, BLOCK))))
        q = tl.minimum(tl.maximum(q, -127.0), 127.0)
        tl.store(codes_ptr + offs, q.to(tl.int8))
        tl.store(scales_ptr + rows, scale)

    return quantize_wire_kernel


@functools.cache
def _dequantize_kernel():
    tr = _bind_triton()

    @tr.jit
    def dequantize_wire_kernel(codes_ptr, scales_ptr, out_ptr, n,
                               ROWS: tl.constexpr, BLOCK: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        offs = rows[:, None] * BLOCK + tl.arange(0, BLOCK)[None, :]
        mask = offs < n
        codes = tl.load(codes_ptr + offs, mask=mask, other=0).to(tl.float32)
        scale = tl.load(scales_ptr + rows)
        tl.store(out_ptr + offs,
                 (codes * scale[:, None]).to(out_ptr.dtype.element_ty),
                 mask=mask)

    return dequantize_wire_kernel


@functools.cache
def _quantize_flat_kernel():
    tr = _bind_triton()

    @tr.jit
    def quantize_flat_kernel(x_ptr, codes_ptr, scales_ptr, n, nb, RECIP,
                             ROWS: tl.constexpr, BLOCK: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        offs = rows[:, None] * BLOCK + tl.arange(0, BLOCK)[None, :]
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        absmax = tl.max(tl.abs(x), axis=1)
        scale = tl.maximum(absmax, 1e-12) * RECIP
        q = libdevice.rint(
            tl.div_rn(x, tl.broadcast_to(scale[:, None], (ROWS, BLOCK))))
        q = tl.minimum(tl.maximum(q, -127.0), 127.0)
        tl.store(codes_ptr + offs, q.to(tl.int8), mask=mask)
        tl.store(scales_ptr + rows, scale, mask=rows < nb)

    return quantize_flat_kernel


@functools.cache
def _dequantize_flat_kernel():
    tr = _bind_triton()

    @tr.jit
    def dequantize_flat_kernel(codes_ptr, scales_ptr, out_ptr, n, nb,
                               ROWS: tl.constexpr, BLOCK: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        offs = rows[:, None] * BLOCK + tl.arange(0, BLOCK)[None, :]
        mask = offs < n
        codes = tl.load(codes_ptr + offs, mask=mask, other=0).to(tl.float32)
        scale = tl.load(scales_ptr + rows, mask=rows < nb, other=0.0)
        tl.store(out_ptr + offs,
                 (codes * scale[:, None]).to(out_ptr.dtype.element_ty),
                 mask=mask)

    return dequantize_flat_kernel


# -- wrappers ----------------------------------------------------------------

def _check_1d(name: str, t: torch.Tensor, dtype=None) -> None:
    if t.dim() != 1:
        raise ValueError(f"{name}: want a flat (n,) tensor, got {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def quantize_flat(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's ``(n,)`` float values -> (codes ``(n,)`` int8, scales
    ``(⌈n/1024⌉,)`` f32), one scale per QBLOCK block. A CPU tensor takes
    the plain version; a CUDA tensor launches the Triton kernel."""
    if on_cpu(x):
        return quantize_flat_plain(x)
    _check_1d("x", x)
    if not x.is_floating_point():
        raise ValueError(f"x: dtype {x.dtype} is not floating")
    n = x.numel()
    nb = ceil_div(n, QBLOCK)
    codes = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    if n:
        _quantize_flat_kernel()[(ceil_div(nb, QBLOCK_ROWS),)](
            x, codes, scales, n, nb, RECIP_127, ROWS=QBLOCK_ROWS,
            BLOCK=QBLOCK, num_warps=NUM_WARPS)
        quantize_flat.launches += 1
    return codes, scales


def dequantize_flat(codes: torch.Tensor, scales: torch.Tensor, n: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_flat``: ``n`` values of ``dtype`` (codes of at
    least ``n`` values, one scale per QBLOCK block). A CPU tensor takes the
    plain version; a CUDA tensor launches the Triton kernel."""
    if on_cpu(codes, scales):
        return dequantize_flat_plain(codes, scales, n, dtype)
    _check_1d("codes", codes, torch.int8)
    _check_1d("scales", scales, torch.float32)
    nb = ceil_div(n, QBLOCK)
    if codes.numel() < n or scales.numel() < nb:
        raise ValueError(f"codes {codes.numel()} / scales {scales.numel()} "
                         f"do not cover n = {n} in blocks of {QBLOCK}")
    out = torch.empty(n, dtype=dtype, device=codes.device)
    if n:
        _dequantize_flat_kernel()[(ceil_div(nb, QBLOCK_ROWS),)](
            codes, scales, out, n, nb, ROWS=QBLOCK_ROWS, BLOCK=QBLOCK,
            num_warps=NUM_WARPS)
        dequantize_flat.launches += 1
    return out


def quantize_wire(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(n,)`` float -> (codes ``(n_pad,)`` int8, scales ``(n_pad/128,)``
    f32), n_pad = ``wire_padded(n)``. A CPU tensor takes the plain
    version; a CUDA tensor launches the Triton kernel."""
    if on_cpu(x):
        return quantize_wire_plain(x)
    _check_1d("x", x)
    if not x.is_floating_point():
        raise ValueError(f"x: dtype {x.dtype} is not floating")
    n = x.numel()
    n_pad = wire_padded(n)
    codes = torch.empty(n_pad, dtype=torch.int8, device=x.device)
    scales = torch.empty(n_pad // WIRE_BLOCK, dtype=torch.float32,
                         device=x.device)
    if n_pad:
        _quantize_kernel()[(n_pad // WIRE_TILE,)](
            x, codes, scales, n, RECIP_127, ROWS=WIRE_TILE_ROWS,
            BLOCK=WIRE_BLOCK,
            num_warps=NUM_WARPS)
        quantize_wire.launches += 1
    return codes, scales


def dequantize_wire(codes: torch.Tensor, scales: torch.Tensor, n: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_wire``, trimmed back to ``n`` values of
    ``dtype``. A CPU tensor takes the plain version; a CUDA tensor
    launches the Triton kernel."""
    if on_cpu(codes, scales):
        return dequantize_wire_plain(codes, scales, n, dtype)
    _check_1d("codes", codes, torch.int8)
    _check_1d("scales", scales, torch.float32)
    tiles = ceil_div(n, WIRE_TILE)
    if codes.numel() < tiles * WIRE_TILE or (
            scales.numel() * WIRE_BLOCK != codes.numel()):
        raise ValueError(f"codes {codes.numel()} / scales {scales.numel()} "
                         f"do not cover n = {n} in whole tiles")
    out = torch.empty(n, dtype=dtype, device=codes.device)
    if n:
        _dequantize_kernel()[(tiles,)](
            codes, scales, out, n, ROWS=WIRE_TILE_ROWS, BLOCK=WIRE_BLOCK,
            num_warps=NUM_WARPS)
        dequantize_wire.launches += 1
    return out


quantize_flat.launches = 0
dequantize_flat.launches = 0
quantize_wire.launches = 0
dequantize_wire.launches = 0
