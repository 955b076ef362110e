"""The port's per-leaf QBLOCK = 1024 int8 codec (``quantize_flat`` /
``dequantize_flat``, plain PyTorch versions — the CPU path of each
wrapper) held against the reference's Pallas pair run in interpret mode
on the same numpy inputs, and its pytree form (``ops.compress`` /
``decompress`` / ``compressed_bytes``) and the KVStore's int8 push outside
the flat elastic rule against the reference's.

Tolerance: none. Codes (unpadded, ``(n,)``), scales (``(⌈n/1024⌉,)``, the
last block's absmax over its real values) and the decoded values equal
the reference's bit for bit. The scale is the compiled reference's
``max(absmax, 1e-12) × f32(1/127)``, called directly or under the jitted
``ops.compress``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.kvstore import KVStore as JKV  # noqa: E402
from repro.kernels.quant_bucket import ops as jops, quant_bucket as jqb  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.kvstore import KVStore as TKV  # noqa: E402
from repro_torch.kernels.quant_bucket import ops as tops, quant_bucket as tqb  # noqa: E402

torch.set_num_threads(2)

SIZES = (1, 896, 1023, 1024, 1025, 8192 + 5, 100_003)


def _values(n, seed):
    """Normal values with edge blocks in front: an all-zero block, a block
    of ±k.5 at absmax 127 (scale 1 and a tie per code, rounding half to
    even), and a block of one huge value among tiny ones."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    ties = np.concatenate([[127.0], np.resize(np.arange(-63, 64) + 0.5, 1023)])
    edge = np.concatenate([np.zeros(1024), ties,
                           np.concatenate([[3e4], np.full(1023, 1e-3)])]).astype(np.float32)
    k = min(n, edge.size)
    x[:k] = edge[:k]
    return x


def _tensor(jx):
    return torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if jx.dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("n", SIZES)
def test_qblock_codec_matches_pallas(n):
    jx = jnp.asarray(_values(n, n))
    jc, js = jqb.quantize_flat(jx, interpret=True)
    before = tqb.quantize_flat.launches, tqb.dequantize_flat.launches
    tc, ts = tqb.quantize_flat(_tensor(jx))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tc.shape) == tuple(jc.shape) == (n,)
    assert tuple(ts.shape) == tuple(js.shape) == (-(-n // 1024),)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jqb.dequantize_flat(jc, js, n, jdt, interpret=True)
        got = tqb.dequantize_flat(tc, ts, n, tdt)
        assert got.dtype == tdt and tuple(got.shape) == (n,)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # the CPU path is the plain version: it counts no launch
    assert (tqb.quantize_flat.launches, tqb.dequantize_flat.launches) == before
    if n >= 3 * 1024:
        assert (tc[:1024] == 0).all()
        want = np.round(np.resize(np.arange(-63, 64) + 0.5, 1023)).astype(np.int8)
        np.testing.assert_array_equal(tc[1025:2048].numpy(), want)
        # an all-zero block: max(0, 1e-12) × f32(1/127), the compiled form
        assert ts[0] == np.float32(1e-12) * (np.float32(1) / np.float32(127))


@pytest.mark.parametrize("n", (1025, 100_003))
def test_qblock_codec_matches_pallas_bf16_input(n):
    jx = jnp.asarray(_values(n, 3 + n)).astype(jnp.bfloat16)
    jc, js = jqb.quantize_flat(jx.astype(jnp.float32), interpret=True)
    tc, ts = tqb.quantize_flat(_tensor(jx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _tree(seed, bf16=False):
    rng = np.random.default_rng(seed)
    shapes = {"emb": (37, 64), "b": {"c": (129,), "d": (7, 11, 2)}, "n": (1024,),
              "w": (3, 1025)}
    tree = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s).astype(np.float32)),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    if bf16:
        tree["b"]["c"] = tree["b"]["c"].astype(jnp.bfloat16)
    return tree


@pytest.mark.parametrize("bf16", [False, True])
def test_compress_decompress_match_reference(bf16):
    jtree = _tree(11, bf16)
    ttree = params_from_numpy(jax.tree.map(np.asarray, jtree))
    jc, js = jops.compress(jtree)
    tc, ts = tops.compress(ttree)
    for got, want in ((tc, jc), (ts, js)):
        for g, w in zip(jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(want)):
            assert g.shape == np.asarray(w).shape
            np.testing.assert_array_equal(g, np.asarray(w))
    jd = jops.decompress(jc, js, jtree)
    td = tops.decompress(tc, ts, ttree)
    for g, w in zip(jax.tree.leaves(params_to_numpy(td)), jax.tree.leaves(jd)):
        assert g.dtype == np.asarray(w).dtype and g.shape == np.asarray(w).shape
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))
    assert tops.compressed_bytes(ttree) == jops.compressed_bytes(jtree)


@pytest.mark.parametrize("kv_type,rule", [("dist_sync", "assign"),
                                          ("dist_async", "elastic")])
def test_int8_push_outside_the_flat_rule_matches_reference(kv_type, rule):
    """An int8 store outside the flat elastic rule (a sync barrier, or the
    elastic rule with ``flat_exchange=False``) pushes each leaf through the
    QBLOCK codec: the stored value and both byte counters equal the
    reference's."""
    stores = []
    for KV, wrap in ((JKV, lambda t: t), (TKV, lambda t: params_from_numpy(
            jax.tree.map(np.asarray, t)))):
        kv = KV.create(kv_type, num_workers=2, wire_dtype="int8",
                       flat_exchange=False)
        kv.init("k", wrap(_tree(20)))
        if rule == "elastic":
            kv.set_elastic(0.5 / 3)
        for seed in (21, 22):
            kv.push("k", wrap(_tree(seed)))
        stores.append((kv.value("k"), kv.pushed_bytes, kv.pushed_bytes_uncompressed))
    (jv, jb, ju), (tv, tb, tu) = stores
    assert (tb, tu) == (jb, ju)
    assert tb == 2 * tops.compressed_bytes(params_from_numpy(
        jax.tree.map(np.asarray, _tree(20))))
    for g, w in zip(jax.tree.leaves(params_to_numpy(tv)), jax.tree.leaves(jv)):
        np.testing.assert_array_equal(g, np.asarray(w))
