"""The int8 wire codec a quantized ring hop puts on the wire.

Ports the plain part of ``repro/kernels/quant_bucket/quant_bucket.py``
(``WIRE_BLOCK``, ``wire_nbytes``, ``wire_encode``, ``wire_decode``,
lines 109-146). The reference writes these in plain ``jnp`` so that XLA
fuses them into each hop; plain PyTorch is their faithful counterpart.
The streaming Pallas pairs of that file (``quantize_wire`` /
``dequantize_wire``, ``quantize_flat`` / ``dequantize_flat``) belong to
the PS tier and are not ported yet.

Exactness: ``scale = max(absmax, 1e-12) / 127`` and the codes are
``round(x / scale)`` — true divisions, never a multiplication by the
reciprocal, rounding half to even as ``jnp.round`` does — so the int8
codes equal the reference's bit for bit, on the CPU and on the card. Both functions take any leading
(device) dims: the codec runs per bucket along the last dim.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: values per int8 scale group on the wire
WIRE_BLOCK = 128


def wire_nbytes(n: int) -> int:
    """Wire bytes of n f32 values in the int8 wire form (codes + scales)."""
    return n + -(-n // WIRE_BLOCK) * 4


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
