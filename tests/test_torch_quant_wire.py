"""The port's streaming int8 wire codec (``quantize_wire`` /
``dequantize_wire``, plain PyTorch versions — the CPU path of each
wrapper) held against the reference's Pallas pair run in interpret mode
on the same numpy inputs, and the packed wire of a whole tree
(``core.elastic.wire_packed``) against the reference's.

Tolerance: none. Codes and scales are equal over the whole padded arrays
(pad buckets included: code 0, scale 1e-12 × f32(1/127)), and the
decoded values equal the reference's bit for bit. The scale is the
compiled reference's ``max(absmax, 1e-12) × f32(1/127)``: XLA turns the
division by the constant 127 into that multiplication."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core import elastic as jel  # noqa: E402
from repro.kernels.quant_bucket import quant_bucket as jqb  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import elastic as tel  # noqa: E402
from repro_torch.kernels.quant_bucket import quant_bucket as tqb  # noqa: E402

torch.set_num_threads(2)

SIZES = (1, 127, 128, 8191, 8192, 8193, 100_003)


def _t(a):
    return params_from_numpy(np.asarray(a))


def _values(n, seed):
    """Normal values with the edge buckets in front: an all-zero bucket,
    a bucket of ±k.5 (absmax 127, so scale 1 and every code a tie that
    rounds half to even), and a bucket of one huge value among tiny ones."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    edge = np.concatenate([
        np.zeros(128, np.float32),
        np.concatenate([[127.0], np.arange(-63, 64, dtype=np.float32) + 0.5]),
        np.concatenate([[3e4], np.full(127, 1e-3, np.float32)]),
    ]).astype(np.float32)
    k = min(n, edge.size)
    x[:k] = edge[:k]
    return x


def _codec_check(x):
    """Encode and decode ``x`` (a numpy-backed jnp array) both ways."""
    n = x.shape[0]
    jc, js = jqb.quantize_wire(x)
    before = tqb.quantize_wire.launches, tqb.dequantize_wire.launches
    tc, ts = tqb.quantize_wire(_t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tc.shape) == tuple(jc.shape) == (tqb.wire_padded(n),)
    assert tuple(ts.shape) == tuple(js.shape) == (tqb.wire_padded(n) // 128,)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jqb.dequantize_wire(jc, js, n)
    td = tqb.dequantize_wire(tc, ts, n)
    assert td.dtype == torch.float32 and tuple(td.shape) == (n,)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the CPU path is the plain version: it counts no launch
    assert (tqb.quantize_wire.launches, tqb.dequantize_wire.launches) == before
    return tc, ts


@pytest.mark.parametrize("n", SIZES)
def test_codec_matches_pallas_f32(n):
    tc, ts = _codec_check(jnp.asarray(_values(n, n)))
    if n >= 3 * 128:
        assert (tc[:128] == 0).all()
        # ±k.5 at scale 1: round half to even
        want = np.round(np.arange(-63, 64) + 0.5).astype(np.int8)
        np.testing.assert_array_equal(tc[129:256].numpy(), want)
    pad_from = -(-n // 128)
    assert (tc[n:] == 0).all()
    # pad buckets: max(0, 1e-12) × f32(1/127), the compiled reference's form
    assert (ts[pad_from:] == np.float32(1e-12) * (np.float32(1) / np.float32(127))).all()


@pytest.mark.parametrize("n", (127, 8193, 100_003))
def test_codec_matches_pallas_bf16_input(n):
    _codec_check(jnp.asarray(_values(n, 7 + n)).astype(jnp.bfloat16))


def test_dequantize_bf16_output_matches_pallas():
    n = 8193
    x = jnp.asarray(_values(n, 3))
    jc, js = jqb.quantize_wire(x)
    jd = jqb.dequantize_wire(jc, js, n, jnp.bfloat16)
    td = tqb.dequantize_wire(_t(jc), _t(js), n, torch.bfloat16)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd).astype(np.float32))


def test_streaming_and_per_hop_scales_differ_by_at_most_one_ulp():
    """The streaming pair multiplies by f32(1/127) where the per-hop codec
    divides by 127: scales within one ulp, decoded values within one
    bucket step of each other."""
    x = torch.from_numpy(_values(100_003, 5))
    sc, ss = tqb.quantize_wire_plain(x)
    hc, hs = tqb.wire_encode(x)
    hs_ = ss[:hs.numel()]
    assert (hs_ != hs).any()
    assert ((hs_.view(torch.int32) - hs.view(torch.int32)).abs() <= 1).all()
    sd = tqb.dequantize_wire(sc, ss, x.numel())
    hd = tqb.wire_decode(hc, hs, x.numel())
    assert ((sd - hd).abs() <= hs.repeat_interleave(128)[:x.numel()] * 1.0001).all()


def test_wire_packed_matches_reference_on_reduced_qwen2():
    """The packed PS-push wire of the whole reduced qwen2-0.5b tree: one
    buffer through the codec, unpacked — equal to the reference's, leaf
    by leaf; bf16 (a cast there and back) too."""
    model = jbuild_model(jreduced(jget_config("qwen2-0.5b")))
    tree = jax.tree.map(np.asarray, model.init(jax.random.key(3)))
    for wire in ("int8", "bf16", None):
        want = jax.tree.leaves(jax.tree.map(
            np.asarray, jel.wire_packed(jax.tree.map(jnp.asarray, tree), wire)))
        got = jax.tree.leaves(params_to_numpy(
            tel.wire_packed(params_from_numpy(tree), wire)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
