"""The port's serving path held against the reference on bridged weights:
the KV-cache serve step and its cache tree, the greedy ``BatchedServer``,
the chunked full-sequence attention, decode against full attention (the
rolling sliding-window buffer included), and quickstart's train →
checkpoint → serve sequence, all on the CPU at reduced size."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.launch.serve import BatchedServer as JBatchedServer  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, get_config, reduced  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.launch.train import make_train_state, make_train_step  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(2)

DENSE = ["qwen2-0.5b", "qwen2.5-3b", "qwen3-4b", "phi3-medium-14b"]
# f32: the two frameworks sum the same products in other orders
RTOL, ATOL = 1e-4, 1e-5


def _offset(tree, rng):
    """Move the zero-initialised QKV biases and norm scales off zero, so
    ``qkv_bias``, ``qk_norm`` and the (1 + scale) norms are exercised."""
    if isinstance(tree, dict):
        return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if not isinstance(v, dict) and (k in ("bq", "bk", "bv") or k.endswith("norm"))
                else _offset(v, rng) for k, v in tree.items()}
    return tree


def _bridged(name, dtype="float32", seed=0):
    jcfg = dataclasses.replace(jreduced(jget_config(name)), dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_config(name)), dtype=dtype)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = _offset(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))),
                 np.random.default_rng(seed))
    return jm, tm, jp, params_from_numpy(jp)


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _teacher_forced(jm, tm, jp, tp, toks, max_seq):
    """Both serve steps over ``toks`` from empty caches: per-step logits
    of each and the final caches."""
    B, T = toks.shape
    jstep = jax.jit(jm.serve_step)
    jc, tc = jm.init_cache(B, max_seq), tm.init_cache(B, max_seq, "cpu")
    jl, tl = [], []
    for t in range(T):
        a, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        b, tc = tm.serve_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        jl.append(_f32(a))
        tl.append(_f32(b))
    return jl, tl, jc, tc


@pytest.mark.parametrize("name", DENSE)
def test_serve_step_and_cache_match_reference(name):
    """Twelve teacher-forced steps into a 10-slot cache (the last two
    overwrite the last slot, as the reference's ``min(idx, size - 1)``):
    logits per step and the cache tree — keys, shapes, dtypes, values."""
    jm, tm, jp, tp = _bridged(name)
    toks = _tokens(jm.cfg, 2, 12)
    jl, tl, jc, tc = _teacher_forced(jm, tm, jp, tp, toks, max_seq=10)
    for t, (want, got) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
    assert sorted(tc) == sorted(jc) == ["index", "k", "v"]
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).replace("torch.", "") == str(jc[key].dtype), key
    L, cfg = jm.cfg.num_layers, jm.cfg
    assert jc["k"].shape == (L, 2, 10, cfg.num_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    np.testing.assert_array_equal(tc["index"].numpy(), np.full(L, 12))
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]), rtol=RTOL, atol=ATOL)


def test_serve_step_bf16_within_band():
    """bf16 activations and cache: both frameworks round the scores, the
    probabilities and each product to bf16 at the same points but sum in
    other orders. Logits reach |1.4|, where one bf16 ulp is 2^-7 =
    0.0078; 12 steps measured ≤ 0.0123 apart; the band is 0.04."""
    jm, tm, jp, tp = _bridged("qwen2-0.5b", dtype="bfloat16")
    toks = _tokens(jm.cfg, 2, 12, seed=1)
    jl, tl, jc, tc = _teacher_forced(jm, tm, jp, tp, toks, max_seq=16)
    for t, (want, got) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.04, err_msg=f"step {t}")
    assert tc["k"].dtype == torch.bfloat16
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]), rtol=0, atol=0.04)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))


@pytest.mark.parametrize("name", DENSE)
def test_batched_server_greedy_tokens_equal_reference(name):
    """Greedy continuation of the reference's ``BatchedServer`` and the
    port's from the same weights and prompts. Equal tokens are implied
    only where the top-1 logit leads the second by more than the logits'
    tolerance, so the test asserts that margin on the reference's logits
    of every chosen token first."""
    jm, tm, jp, tp = _bridged(name, seed=2)
    prompts = _tokens(jm.cfg, 2, 6, seed=2)
    want = np.asarray(JBatchedServer(jm, jp, batch=2, max_seq=32).generate(
        jnp.asarray(prompts), steps=8))
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    jl, _, _, _ = _teacher_forced(jm, tm, jp, tp, seq, max_seq=32)
    chosen = np.concatenate(jl[prompts.shape[1] - 1:], axis=1)[..., :jm.cfg.vocab_size]
    top2 = np.sort(chosen, axis=-1)[..., -2:]
    assert float(np.min(top2[..., 1] - top2[..., 0])) > 100 * ATOL
    np.testing.assert_array_equal(np.argmax(chosen, -1), want)
    srv = BatchedServer(tm, tp, batch=2, max_seq=32, device="cpu")
    got = srv.generate(torch.from_numpy(prompts), steps=8)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert srv.cache["index"].tolist() == [6 + 8] * tm.cfg.num_layers


def test_batched_server_generates():
    """``tests/test_launch.py::test_batched_server_generates`` on the port."""
    model = build_model(reduced(get_config("qwen2-0.5b")))
    params = model.init(device="cpu", seed=0)
    srv = BatchedServer(model, params, batch=2, max_seq=32, device="cpu")
    out = srv.generate(torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32), steps=4)
    assert tuple(out.shape) == (2, 4)
    assert int(out.max()) < model.cfg.padded_vocab


def test_serve_step_updates_the_cache_in_place():
    """The serve step consumes its cache: k / v are written into the same
    storage and returned, ``index`` advances as a new tensor."""
    model = build_model(reduced(get_config("qwen3-4b")))
    params = model.init(device="cpu", seed=0)
    cache = model.init_cache(2, 8, "cpu")
    k, v, index = cache["k"], cache["v"], cache["index"]
    logits, new = model.serve_step(params, cache, torch.tensor([[3], [5]], dtype=torch.int32))
    assert new["k"] is k and new["v"] is v and new["index"] is not index
    assert index.tolist() == [0, 0] and new["index"].tolist() == [1, 1]
    assert bool(k[:, :, 0].abs().sum(-1).gt(0).all()) and not bool(k[:, :, 1:].any())
    assert not logits.requires_grad


def test_serve_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(reduced(get_config("qwen2-0.5b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServer(model, model.init(device="cpu"), batch=2, max_seq=8)


@pytest.mark.parametrize("shape", sorted(JSHAPES))
def test_input_specs_match_reference(shape):
    jm = jbuild_model(jget_config("qwen3-4b"))
    tm = build_model(get_config("qwen3-4b"))
    want = jm.input_specs(JSHAPES[shape])
    got = tm.input_specs(INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape and got[k].dtype == torch.int32


# ---------------------------------------------------------------------------
# attention: chunked, cross, decode (tests/test_models.py's semantics)
# ---------------------------------------------------------------------------

def _spec_pair(**kw):
    base = dict(num_heads=4, num_kv_heads=2, head_dim=16)
    base.update(kw)
    return jattn.AttnSpec(**base), tattn.AttnSpec(**base)


def _attn_params(jspec, seed):
    jp = jattn.init_attention(jax.random.key(seed), 32, jspec, jnp.float32)
    jp = _offset(jax.tree.map(np.asarray, jp), np.random.default_rng(seed))
    return jp, params_from_numpy(jp)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("spec_kw, S", [
    ({}, 64),
    ({"num_kv_heads": 1}, 96),
    ({"qk_norm": True}, 64),
    ({"qkv_bias": True}, 64),
    ({"sliding_window": 24}, 96),
    ({"prefix_len": 16}, 64),
    ({"prefix_len": 40}, 64),
    ({"causal": False}, 48),
], ids=["gqa", "mqa", "qk_norm", "qkv_bias", "window", "prefix", "prefix_long", "bidir"])
def test_chunked_attention_matches_oracle_and_reference(spec_kw, S):
    """16 × 16 chunks against the O(S²) oracle (the reference's own
    2e-4 band) and against the reference's chunked path with the same
    chunks (f32 tolerance)."""
    jspec, tspec = _spec_pair(**spec_kw)
    jp, tp = _attn_params(jspec, 0)
    x = _x((2, S, 32), 1)
    with torch.no_grad():
        got = tattn.multi_head_attention(tp, torch.from_numpy(x), tspec,
                                         q_chunk=16, kv_chunk=16).numpy()
        oracle = tattn.reference_attention(tp, torch.from_numpy(x), tspec).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    want = jattn.multi_head_attention(jp, jnp.asarray(x), jspec, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(oracle, np.asarray(jattn.reference_attention(
        jp, jnp.asarray(x), jspec)), rtol=RTOL, atol=ATOL)


def test_cross_attention_matches_oracle_and_reference():
    jspec, tspec = _spec_pair(causal=False, use_rope=False)
    jp, tp = _attn_params(jspec, 1)
    x, enc = _x((2, 20, 32), 2, 1.0), _x((2, 50, 32), 3, 1.0)
    with torch.no_grad():
        got = tattn.multi_head_attention(tp, torch.from_numpy(x), tspec,
                                         x_kv=torch.from_numpy(enc), q_chunk=8,
                                         kv_chunk=16).numpy()
        oracle = tattn.reference_attention(tp, torch.from_numpy(x), tspec,
                                           x_kv=torch.from_numpy(enc)).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    want = jattn.multi_head_attention(jp, jnp.asarray(x), jspec, x_kv=jnp.asarray(enc),
                                      q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_one_chunk_runs_the_single_block_softmax():
    """A sequence inside one chunk and one block runs the single-block
    softmax (no rescale): chunk sizes at or above S give the same bits."""
    _, tspec = _spec_pair(qkv_bias=True)
    _, tp = _attn_params(_spec_pair(qkv_bias=True)[0], 4)
    x = torch.from_numpy(_x((2, 64, 32), 5))
    with torch.no_grad():
        a = tattn.multi_head_attention(tp, x, tspec)
        b = tattn.multi_head_attention(tp, x, tspec, q_chunk=64, kv_chunk=64)
        c = tattn.multi_head_attention(tp, x, tspec, q_chunk=64, kv_chunk=32)
    assert torch.equal(a, b)
    torch.testing.assert_close(c, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window, S, tol", [(0, 12, 2e-4), (8, 20, 3e-4)],
                         ids=["full", "rolling_window_8"])
def test_decode_matches_full_attention(window, S, tol):
    """Token-by-token decode through the KV cache == full causal
    attention (the reference's bands); a sliding window keeps a
    window-sized rolling buffer. Each step also == the reference's
    decode step on the same cache."""
    jspec, tspec = _spec_pair(sliding_window=window)
    jp, tp = _attn_params(jspec, 6)
    B = 2
    x = _x((B, S, 32), 7)
    full = tattn.reference_attention(tp, torch.from_numpy(x), tspec).numpy()
    cache = tattn.init_kv_cache(B, S, tspec, torch.float32, "cpu")
    jcache = jattn.init_kv_cache(B, S, jspec, jnp.float32)
    assert tuple(cache["k"].shape) == jcache["k"].shape == (B, window or S, 2, 16)
    outs = []
    for t in range(S):
        o, cache = tattn.decode_attention(tp, torch.from_numpy(x[:, t:t + 1]), cache, tspec)
        jo, jcache = jattn.decode_attention(jp, jnp.asarray(x[:, t:t + 1]), jcache, jspec)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
        outs.append(o.numpy())
    np.testing.assert_allclose(np.concatenate(outs, 1), full, rtol=tol, atol=tol)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=RTOL, atol=ATOL)
    assert int(cache["index"]) == int(jcache["index"]) == S


# ---------------------------------------------------------------------------
# quickstart: train -> checkpoint round trip -> serve
# ---------------------------------------------------------------------------

def test_quickstart_train_checkpoint_serve(tmp_path):
    """``examples/quickstart.py``'s sequence through the port on the CPU:
    mpi-SGD steps of reduced qwen2-0.5b on the bigram data, an npz
    checkpoint round trip, then a greedy continuation."""
    model = build_model(reduced(get_config("qwen2-0.5b")))
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=64,
                                    batch_size=8, steps_per_epoch=4))
    opt, sync = sgd(0.1, momentum=0.9), SyncConfig(mode="mpi_sgd", num_clients=1)
    state = make_train_state(model, opt, sync, device="cpu")
    step = make_train_step(model, opt, sync, device="cpu")
    losses = []
    for batch in pipe.epoch(0):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state["params"], step=len(losses))
    params, meta = restore_checkpoint(path, tree_map(torch.zeros_like, state["params"]))
    assert meta["step"] == 4
    srv = BatchedServer(model, params, batch=2, max_seq=96, device="cpu")
    prompts = pipe.batch_at(1, 0)["tokens"][:2, :8]
    out = srv.generate(prompts, steps=12)
    assert tuple(out.shape) == (2, 12)
    assert 0 <= int(out.min()) and int(out.max()) < model.cfg.vocab_size
    ref = BatchedServer(model, state["params"], batch=2, max_seq=96, device="cpu")
    assert torch.equal(ref.generate(prompts, steps=12), out)
