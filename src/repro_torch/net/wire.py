"""Frame + payload codec for the socket-backed PS tier
(``repro/net/wire.py``).

A frame is::

    MAGIC(4) | header_len u32 | payload_len u32 | header JSON | payload

both length fields big-endian. The header is a small JSON dict carrying
the op name and metadata (compact separators, ``op`` last: byte-equal to
the reference's); the payload is the tensor bytes.

Payloads are FlatBuffer-packed f32 buffers (core/flatbuf.py) encoded per
wire dtype with the per-hop codec the in-process collectives use
(kernels/quant_bucket ``wire_encode`` / ``wire_decode``: the CUDA kernels
of ``csrc/wire_hop.cu`` for a buffer on the card, their plain versions on
the CPU; both the divide form, not the streaming kernel's reciprocal):

  f32   raw little-endian f32             4n bytes
  bf16  bfloat16 cast (round to nearest   2n bytes
        even, as ml_dtypes)
  int8  codes + per-128 f32 scales        n + ceil(n/128)*4 bytes
        (WIRE_BLOCK buckets)

so the bytes on the socket equal ``cost_model.ps_wire_nbytes(n, wd)``
exactly. A buffer is encoded on its own device and only the wire form
(codes and scales for int8, the cast for bf16) is copied to the host;
``decode_buffer`` rebuilds the f32 view on the receiver's device.
"""
from __future__ import annotations

import json
import struct
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.quant_bucket.quant_bucket import (
    WIRE_BLOCK,
    wire_decode,
    wire_encode,
)

MAGIC = b"RKV1"
_HEAD = struct.Struct("!4sII")


class WireError(RuntimeError):
    """Malformed frame (bad magic, truncated stream, bad header)."""


def encode_frame(op: str, meta: Optional[dict] = None,
                 payload: bytes = b"") -> bytes:
    header = dict(meta or {})
    header["op"] = op
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    return _HEAD.pack(MAGIC, len(hbytes), len(payload)) + hbytes + payload


def decode_frame(data: bytes) -> tuple[str, dict, bytes]:
    """Inverse of ``encode_frame`` for an in-memory frame."""
    if len(data) < _HEAD.size:
        raise WireError(f"frame truncated: {len(data)} bytes")
    magic, hlen, plen = _HEAD.unpack_from(data)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if len(data) != _HEAD.size + hlen + plen:
        raise WireError(
            f"frame length mismatch: header says {_HEAD.size + hlen + plen},"
            f" got {len(data)}")
    header = json.loads(data[_HEAD.size:_HEAD.size + hlen])
    op = header.pop("op")
    return op, header, data[_HEAD.size + hlen:]


def read_frame(read_exact: Callable[[int], bytes]) -> tuple[str, dict, bytes]:
    """Read one frame from a stream via ``read_exact(n) -> n bytes``."""
    head = read_exact(_HEAD.size)
    magic, hlen, plen = _HEAD.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    header = json.loads(read_exact(hlen))
    op = header.pop("op")
    return op, header, read_exact(plen)


# ---------------------------------------------------------------------------
# Payload codec: packed f32 buffer <-> wire bytes per wire dtype
# ---------------------------------------------------------------------------

def _host_bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().numpy().tobytes()


def encode_buffer(buf: torch.Tensor,
                  wire_dtype: Optional[str] = None) -> tuple[dict, bytes]:
    """Encode a packed f32 buffer (a tensor on any device, any shape) into
    (meta, payload). The int8 form flattens and ships codes then scales."""
    x = buf.detach().to(torch.float32)
    meta = {"shape": [int(s) for s in x.shape], "wire": wire_dtype or "f32"}
    if wire_dtype in (None, "f32"):
        return meta, _host_bytes(x)
    if wire_dtype == "bf16":
        return meta, _host_bytes(x.to(torch.bfloat16).view(torch.int16))
    if wire_dtype == "int8":
        codes, scales = wire_encode(x.reshape(-1))
        return meta, _host_bytes(codes) + _host_bytes(scales)
    raise ValueError(f"wire_dtype must be None/f32/bf16/int8, "
                     f"got {wire_dtype!r}")


def _from_host(payload: bytes, dtype, count: int, offset: int = 0
               ) -> torch.Tensor:
    # np.frombuffer is a read-only view of the frame: copy it out
    return torch.from_numpy(
        np.frombuffer(payload, dtype, count, offset).copy())


def decode_buffer(meta: dict, payload: bytes, device="cpu") -> torch.Tensor:
    """Inverse of ``encode_buffer``: the receiver's f32 view, on
    ``device``."""
    shape = tuple(meta["shape"])
    n = int(np.prod(shape)) if shape else 1
    wire = meta.get("wire", "f32")
    if wire == "f32":
        return _from_host(payload, np.float32, n).to(device).reshape(shape)
    if wire == "bf16":
        raw = _from_host(payload, np.int16, n).to(device)
        return raw.view(torch.bfloat16).to(torch.float32).reshape(shape)
    if wire == "int8":
        n_pad = -(-n // WIRE_BLOCK) * WIRE_BLOCK
        codes = _from_host(payload, np.int8, n_pad).to(device)
        scales = _from_host(payload, np.float32, n_pad // WIRE_BLOCK,
                            n_pad).to(device)
        return wire_decode(codes, scales, n).reshape(shape)
    raise ValueError(f"unknown wire form {wire!r} in frame header")


def payload_nbytes(n_values: int, wire_dtype: Optional[str] = None) -> int:
    """Exact payload bytes ``encode_buffer`` emits for ``n_values`` f32
    values — the quantity ``cost_model.ps_wire_nbytes`` predicts."""
    if wire_dtype in (None, "f32"):
        return 4 * n_values
    if wire_dtype == "bf16":
        return 2 * n_values
    if wire_dtype == "int8":
        n_pad = -(-n_values // WIRE_BLOCK) * WIRE_BLOCK
        return n_pad + (n_pad // WIRE_BLOCK) * 4
    raise ValueError(f"wire_dtype must be None/f32/bf16/int8, "
                     f"got {wire_dtype!r}")
