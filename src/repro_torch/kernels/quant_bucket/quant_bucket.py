"""The int8 codecs: the per-hop plain form and the streaming kernels.

Ports ``repro/kernels/quant_bucket/quant_bucket.py``:

  quantize_flat              (:56)         the QBLOCK = 1024 PS-push codec,
  dequantize_flat            (:83)         one f32 scale per 1024 values:
                                           the per-leaf compress path
                                           (``ops.compress`` /
                                           ``decompress``), hand-written
                                           Triton kernels
  wire_encode / wire_decode  (:114, :137)  the per-hop codec a quantized
                                           ring hop runs; the reference
                                           writes it in plain ``jnp`` so
                                           XLA fuses it into each hop; here
                                           a hand-written CUDA C++ kernel
                                           (``csrc/wire_hop.cu``) does that
                                           fusion, with the hop's f32
                                           accumulate in
                                           ``wire_decode_add_encode``
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

**The per-hop kernels** (``csrc/wire_hop.cu``, built by
``kernels/cuda_build`` at first use): ``wire_encode`` (values -> codes and
scales), ``wire_decode`` (codes and scales -> f32 values trimmed to n) and
``wire_decode_add_encode`` (received codes and scales plus the local chunk
-> the f32 sum re-encoded for the next hop, or the sum itself on a
reduce-scatter's last step), each one pass over ``(…, n)`` rows that are
padded on their own to whole buckets: ``wire_encode``'s layout. The
values' rows may be evenly strided (each row contiguous), so an
allgather's per-ring shard needs no copy. One warp takes one bucket, its
absmax a warp-shuffle max; the arithmetic is the plain codec's, IEEE
division included, so codes, scales and sums equal the plain versions
bit for bit. A CPU tensor takes the plain versions (``*_plain``), the
card's reference too.

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
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build
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


def wire_encode_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
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


def wire_decode_plain(codes: torch.Tensor, scales: torch.Tensor,
                      n: int | None = None) -> torch.Tensor:
    """Inverse of ``wire_encode_plain``: -> ``(…, n)`` f32 (``n`` trims
    the encoder's bucket padding)."""
    lead = tuple(codes.shape[:-1])
    out = (codes.reshape(lead + (-1, WIRE_BLOCK)).float()
           * scales.unsqueeze(-1)).reshape(lead + (-1,))
    return out if n is None else out[..., :n]


def wire_decode_add_encode_plain(codes: torch.Tensor, scales: torch.Tensor,
                                 local: torch.Tensor, n: int, *, last: bool = False):
    """One int8 ring hop's accumulate: ``local`` (``(…, n)`` float) plus
    the decoded received ``codes`` / ``scales``, in f32 — re-encoded as
    the next hop's (codes, scales), or the f32 sum itself when ``last``."""
    total = local.float() + wire_decode_plain(codes, scales, n)
    return total if last else wire_encode_plain(total)


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
    return wire_decode_plain(codes, scales, n).to(dtype)


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


# -- the per-hop codec: CUDA C++ (csrc/wire_hop.cu) ----------------------------

def _row_stride(name: str, t: torch.Tensor) -> int:
    """The element stride between consecutive rows of ``t`` (``(…, n)``,
    its leading dims flattened into rows); raises unless every row is
    contiguous and the rows are evenly strided, the layout the kernels
    take."""
    if t.dim() == 0:
        raise ValueError(f"{name}: want a (…, n) tensor, got a scalar")
    n = t.shape[-1]
    if n > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: rows not contiguous (stride {t.stride()})")
    dims = [(size, stride) for size, stride in zip(t.shape[:-1], t.stride()[:-1])
            if size > 1]
    if not dims:
        return n
    step = dims[-1][1]
    want = step
    for size, stride in reversed(dims):
        if stride != want:
            raise ValueError(f"{name}: rows not evenly strided "
                             f"(shape {tuple(t.shape)}, stride {t.stride()})")
        want = stride * size
    return step


def _check_values(name: str, t: torch.Tensor) -> int:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {t.dtype}, want float32 or bfloat16")
    return _row_stride(name, t)


def _check_wire(codes: torch.Tensor, scales: torch.Tensor) -> int:
    """Check an encoded ``(…, nb·128)`` int8 / ``(…, nb)`` f32 pair (both
    contiguous, one lead shape); returns nb."""
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"codes / scales: dtypes {codes.dtype} / {scales.dtype}, "
                         "want int8 / float32")
    if codes.dim() == 0 or codes.shape[:-1] != scales.shape[:-1] or (
            codes.shape[-1] != scales.shape[-1] * WIRE_BLOCK):
        raise ValueError(f"codes {tuple(codes.shape)} / scales {tuple(scales.shape)}: "
                         f"want (…, nb·{WIRE_BLOCK}) / (…, nb)")
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("codes / scales: not contiguous")
    return scales.shape[-1]


def _launch(fn: str, *args) -> None:
    """One launch of ``csrc/wire_hop.cu``'s ``fn`` on the current stream
    of the current device; raises on a refused launch."""
    lib = cuda_build.load_library("wire_hop")
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, fn)


def wire_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(…, n)`` float -> (codes ``(…, n_pad)`` int8, scales
    ``(…, n_pad/128)`` f32), each row padded on its own to whole
    WIRE_BLOCK buckets (zeros, which never raise a bucket's absmax; an
    all-zero bucket has scale ~7.9e-15 and decodes to exactly 0.0). A CPU
    tensor takes the plain version; a CUDA tensor (f32 or bf16, rows
    contiguous and evenly strided) launches the kernel of
    ``csrc/wire_hop.cu``."""
    if on_cpu(x):
        return wire_encode_plain(x)
    stride = _check_values("x", x)
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    nb = ceil_div(n, WIRE_BLOCK)
    codes = torch.empty(lead + (nb * WIRE_BLOCK,), dtype=torch.int8, device=x.device)
    scales = torch.empty(lead + (nb,), dtype=torch.float32, device=x.device)
    rows = math.prod(lead)
    if rows * n:
        with torch.cuda.device(x.device):
            _launch("wire_encode_cuda", x.data_ptr(), stride,
                    int(x.dtype == torch.bfloat16), codes.data_ptr(),
                    scales.data_ptr(), rows, n)
        wire_encode.launches += 1
    return codes, scales


def wire_decode(codes: torch.Tensor, scales: torch.Tensor,
                n: int | None = None) -> torch.Tensor:
    """Inverse of ``wire_encode``: -> ``(…, n)`` f32 (``n`` trims the
    encoder's bucket padding). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel of ``csrc/wire_hop.cu``."""
    if on_cpu(codes, scales):
        return wire_decode_plain(codes, scales, n)
    nb = _check_wire(codes, scales)
    n = codes.shape[-1] if n is None else n
    if not 0 <= n <= codes.shape[-1]:
        raise ValueError(f"n = {n} outside the {codes.shape[-1]} encoded values a row")
    lead = tuple(codes.shape[:-1])
    out = torch.empty(lead + (n,), dtype=torch.float32, device=codes.device)
    rows = math.prod(lead)
    if rows * n:
        with torch.cuda.device(codes.device):
            _launch("wire_decode_cuda", codes.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), rows, n, nb)
        wire_decode.launches += 1
    return out


def wire_decode_add_encode(codes: torch.Tensor, scales: torch.Tensor,
                           local: torch.Tensor, n: int, *, last: bool = False):
    """One int8 ring hop's accumulate in one pass: the received ``codes`` /
    ``scales`` decoded and added to ``local`` (``(…, n)``, f32 or bf16)
    in f32, re-encoded as the next hop's (codes, scales) — or, when
    ``last``, the ``(…, n)`` f32 sum. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel of ``csrc/wire_hop.cu`` (the sum
    never reaches memory unless ``last``)."""
    if on_cpu(codes, scales, local):
        return wire_decode_add_encode_plain(codes, scales, local, n, last=last)
    nb = _check_wire(codes, scales)
    stride = _check_values("local", local)
    if local.shape[-1] != n or tuple(local.shape[:-1]) != tuple(codes.shape[:-1]) or (
            nb != ceil_div(n, WIRE_BLOCK)):
        raise ValueError(f"local {tuple(local.shape)}, codes {tuple(codes.shape)}: want "
                         f"(…, {n}) and (…, {ceil_div(n, WIRE_BLOCK) * WIRE_BLOCK})")
    lead = tuple(local.shape[:-1])
    dev = local.device
    if last:
        out = (torch.empty(lead + (n,), dtype=torch.float32, device=dev),)
        ptrs = (None, None, out[0].data_ptr())
    else:
        out = (torch.empty_like(codes), torch.empty_like(scales))
        ptrs = (out[0].data_ptr(), out[1].data_ptr(), None)
    rows = math.prod(lead)
    if rows * n:
        with torch.cuda.device(dev):
            _launch("wire_decode_add_encode_cuda", codes.data_ptr(), scales.data_ptr(),
                    local.data_ptr(), stride, int(local.dtype == torch.bfloat16),
                    *ptrs, rows, n)
        wire_decode_add_encode.launches += 1
    return out[0] if last else out


quantize_flat.launches = 0
dequantize_flat.launches = 0
quantize_wire.launches = 0
dequantize_wire.launches = 0
wire_encode.launches = 0
wire_decode.launches = 0
wire_decode_add_encode.launches = 0
