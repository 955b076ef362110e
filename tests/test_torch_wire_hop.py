"""The per-hop int8 codec of the port's rings (``kernels.quant_bucket``'s
``wire_encode`` / ``wire_decode`` / ``wire_decode_add_encode``: CUDA C++
in ``csrc/wire_hop.cu`` on the card, their plain versions on the CPU) held
against the reference's inline codec (``repro.kernels.quant_bucket``'s
``wire_encode`` / ``wire_decode``, called op by op: the eager form that
divides by 127) on the same numpy inputs; and the int8 rings and socket
frames built on it against the reference's.

Tolerance: none. Codes, scales, f32 sums, ring shards, wire bytes and
frames are equal bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import collectives as JC  # noqa: E402
from repro.kernels.quant_bucket import quant_bucket as jqb  # noqa: E402
from repro.net import wire as jwire  # noqa: E402
from repro_torch.core import collectives as TC  # noqa: E402
from repro_torch.kernels.quant_bucket import quant_bucket as tqb  # noqa: E402
from repro_torch.net import wire as twire  # noqa: E402
from test_torch_quant_wire import SIZES, _values  # noqa: E402

torch.set_num_threads(2)

HOP_KERNELS = (tqb.wire_encode, tqb.wire_decode, tqb.wire_decode_add_encode)


def _launches():
    return tuple(k.launches for k in HOP_KERNELS)


def _hop_inputs(n, rows, seed, local_dtype):
    """A received (codes, scales) pair — the reference's encode of edge-
    bucket values — and a local chunk of other values, ``rows`` of each."""
    sent = np.stack([_values(n, seed + r) for r in range(rows)])
    local = np.stack([_values(n, seed + 100 + r)[::-1] * 3 for r in range(rows)])
    local = np.ascontiguousarray(local)
    enc = [jqb.wire_encode(jnp.asarray(row)) for row in sent]
    codes = np.stack([np.asarray(c) for c, _ in enc])
    scales = np.stack([np.asarray(s) for _, s in enc])
    tlocal = torch.from_numpy(local).to(local_dtype)
    return codes, scales, tlocal


def _reference_hop(codes, scales, local, n, last):
    """The reference's dequantize-accumulate-requantize, row by row, op by
    op: ``local.astype(f32) + wire_decode(...)``, then ``wire_encode``."""
    out = []
    for c, s, x in zip(codes, scales, local):
        total = jnp.asarray(x.float().numpy()) + jqb.wire_decode(
            jnp.asarray(c), jnp.asarray(s), n)
        out.append(total if last else jqb.wire_encode(total))
    if last:
        return (np.stack([np.asarray(t) for t in out]),)
    return (np.stack([np.asarray(c) for c, _ in out]),
            np.stack([np.asarray(s) for _, s in out]))


@pytest.mark.parametrize("last", [False, True], ids=["hop", "last"])
@pytest.mark.parametrize("local_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_decode_add_encode_plain_equals_reference(n, rows, local_dtype, last):
    codes, scales, local = _hop_inputs(n, rows, n + rows, local_dtype)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(scales)
    before = _launches()
    got = tqb.wire_decode_add_encode(tc, ts, local, n, last=last)
    assert _launches() == before          # a CPU tensor: the plain version
    got = (got,) if last else got
    composed = local.float() + tqb.wire_decode_plain(tc, ts, n)
    composed = (composed,) if last else tqb.wire_encode_plain(composed)
    want = _reference_hop(codes, scales, local, n, last)
    assert len(got) == len(want) == len(composed)
    for g, c, w in zip(got, composed, want):
        assert g.dtype == c.dtype and tuple(g.shape) == w.shape
        assert torch.equal(g, c)
        np.testing.assert_array_equal(g.numpy(), w)
    if not last:
        assert tuple(got[0].shape) == (rows, -(-n // 128) * 128)
        assert tuple(got[1].shape) == (rows, -(-n // 128))


@pytest.mark.parametrize("n", SIZES)
def test_encode_decode_wrappers_equal_reference_on_the_edge_buckets(n):
    x = _values(n, 11 * n)
    before = _launches()
    codes, scales = tqb.wire_encode(torch.from_numpy(x))
    jc, js = jqb.wire_encode(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tqb.wire_decode(codes, scales, n).numpy(),
                                  np.asarray(jqb.wire_decode(jc, js, n)))
    assert _launches() == before
    if n >= 3 * 128:
        assert (codes[:128] == 0).all() and (scales[0] == np.float32(1e-12) / 127)
        want = np.round(np.arange(-63, 64) + 0.5).astype(np.int8)   # ties to even
        np.testing.assert_array_equal(codes[129:256].numpy(), want)


def test_encode_takes_strided_rows():
    """An allgather's per-ring shard (``select(-2, r)``: rows strided by
    the ring count) encodes as its contiguous copy does."""
    x = torch.from_numpy(np.stack([_values(2 * 300, s) for s in range(3)]))
    shards = x.reshape(3, 2, 300)
    for r in range(2):
        view = shards.select(-2, r)
        assert not view.is_contiguous()
        assert tqb._row_stride("x", view) == 600
        for g, w in zip(tqb.wire_encode(view), tqb.wire_encode(view.contiguous())):
            assert torch.equal(g, w)


def test_row_layout_checks():
    assert tqb._row_stride("x", torch.zeros(4, 1, 10)) == 10
    assert tqb._row_stride("x", torch.zeros(2, 3, 2, 10)[:, :, 1]) == 20
    assert tqb._row_stride("x", torch.zeros(1, 1, 7)) == 7
    with pytest.raises(ValueError, match="evenly strided"):
        tqb._row_stride("x", torch.zeros(2, 4, 10)[:, :3])
    with pytest.raises(ValueError, match="not contiguous"):
        tqb._row_stride("x", torch.zeros(10, 4)[:, 0])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tqb._check_values("x", torch.zeros(4, dtype=torch.float16))
    codes, scales = tqb.wire_encode_plain(torch.randn(2, 300))
    assert tqb._check_wire(codes, scales) == 3
    with pytest.raises(ValueError, match="want"):
        tqb._check_wire(codes[:, :256], scales)
    with pytest.raises(ValueError, match="dtypes"):
        tqb._check_wire(codes.float(), scales)


@pytest.mark.parametrize("rings", [1, 2])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_int8_rings_equal_reference(p, rings, n=1037):
    """The int8 reduce-scatter (encode once, then one fused decode-add-
    encode a hop) and allgather equal the reference's emulated rings shard
    for shard; the bytes on the wire are every hop's padded codes and
    scales, as before; no launch counted on the CPU."""
    x = np.stack([_values(n, 7 * p + i) * (i + 1) for i in range(p)])
    want_rs = JC.emulate(JC.ring_reduce_scatter, jnp.asarray(x), num_rings=rings,
                         wire_dtype="int8")
    before = _launches()
    meter = TC.WireMeter()
    got_rs = TC.ring_reduce_scatter(torch.from_numpy(x), 0, num_rings=rings,
                                    wire_dtype="int8", meter=meter)
    np.testing.assert_array_equal(got_rs.numpy(), np.asarray(want_rs))
    buckets = -(-n // (p * rings) // 128)     # each hop's chunk, whole buckets
    hop_bytes = buckets * (128 + 4)
    assert meter.bytes == (p - 1) * rings * hop_bytes
    meter.reset()
    want_ag = JC.emulate(JC.ring_allgather, want_rs, num_rings=rings,
                         wire_dtype="int8")
    got_ag = TC.ring_allgather(got_rs, 0, num_rings=rings, wire_dtype="int8",
                               meter=meter)
    np.testing.assert_array_equal(got_ag.numpy(), np.asarray(want_ag))
    assert meter.bytes == (p - 1) * rings * hop_bytes
    assert _launches() == before


def test_int8_reduce_scatter_takes_bf16_input():
    x = np.stack([_values(1037, 40 + i) for i in range(3)])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = JC.emulate(JC.ring_reduce_scatter, xb, num_rings=2, wire_dtype="int8")
    got = TC.ring_reduce_scatter(torch.from_numpy(np.asarray(xb.astype(jnp.float32)))
                                 .to(torch.bfloat16), 0, num_rings=2, wire_dtype="int8")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_int8_frames_equal_reference(n):
    """``net/wire.encode_buffer``'s int8 payload is the reference's byte for
    byte, and ``decode_buffer`` gives the reference's f32 view."""
    x = _values(n, 3 * n)
    before = _launches()
    meta, payload = twire.encode_buffer(torch.from_numpy(x), "int8")
    jmeta, jpayload = jwire.encode_buffer(x, "int8")
    assert meta == jmeta and payload == jpayload
    assert len(payload) == twire.payload_nbytes(n, "int8")
    np.testing.assert_array_equal(twire.decode_buffer(meta, payload).numpy(),
                                  np.asarray(jwire.decode_buffer(jmeta, jpayload)))
    assert _launches() == before
