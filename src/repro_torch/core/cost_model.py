"""Wire-byte accounting of the ring legs (``repro/core/cost_model.py``,
the byte functions of lines 41-84).

Only the byte functions are ported: the α-β-γ time constants of the
reference describe its testbed and a TPU, not this port's hardware, and
an H100 model comes from a measured run. The emulated collectives count
the bytes each hop puts on the wire (``core.collectives.WireMeter``), and
the tests hold those counts to these functions.
"""
from __future__ import annotations

#: f32 -> wire byte ratio per wire dtype. int8 counts the codes (1 byte
#: per value) plus one f32 scale per WIRE_BLOCK = 128 bucket, matching
#: ``kernels.quant_bucket.wire_encode``: (1 + 4/128)/4 = 0.2578125.
WIRE_RATIO = {
    None: 1.0,
    "f32": 1.0,
    "bf16": 0.5,
    "int8": (1 + 4 / 128) / 4,
}


def wire_ratio(wire_dtype: "str | None" = None) -> float:
    try:
        return WIRE_RATIO[wire_dtype]
    except KeyError:
        raise ValueError(
            f"wire_dtype must be one of {tuple(WIRE_RATIO)}, "
            f"got {wire_dtype!r}") from None


def wire_bytes(nbytes: float, wire_dtype: "str | None" = None) -> float:
    """f32 payload bytes -> bytes that actually cross the wire."""
    return nbytes * wire_ratio(wire_dtype)


def grad_leg_bytes(nbytes: float, p: int,
                   wire_dtype: "str | None" = None) -> float:
    """Per-device gradient-leg wire bytes of the sharded fused step: the
    ring reduce-scatter's (p−1)/p·n, scaled by the wire dtype."""
    if p <= 1:
        return 0.0
    return (p - 1) / p * wire_bytes(nbytes, wire_dtype)


def param_leg_bytes(nbytes: float, p: int,
                    wire_dtype: "str | None" = None) -> float:
    """Per-device param-allgather wire bytes (the second half)."""
    return grad_leg_bytes(nbytes, p, wire_dtype)


def elastic_leg_bytes(nbytes: float, p: int,
                      wire_dtype: "str | None" = None) -> float:
    """Per-device wire bytes of one sharded elastic exchange: the packed
    diff reduce-scatter + the center-shard allgather."""
    return 2 * grad_leg_bytes(nbytes, p, wire_dtype)
