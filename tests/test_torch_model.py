"""The port's dense decoder held against the reference on bridged weights:
building blocks, the loss and its gradients (reduced qwen2-0.5b, f32)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.models import attention as jattn, layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.transformer import attn_spec as jattn_spec  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tattn, layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.transformer import attn_spec as tattn_spec  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return params_from_numpy(np.asarray(a))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_scales_by_one_plus_scale():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 3, 5, 64), _rand(rng, 64, scale=0.1)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = tlayers.rms_norm(_t(x), _t(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # zero scales are the identity gain, unlike torch.nn.RMSNorm's weight
    ones = tlayers.rms_norm(_t(x), torch.zeros(64))
    ref = torch.nn.functional.rms_norm(_t(x), (64,), torch.ones(64), 1e-6)
    torch.testing.assert_close(ones, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_rotates_split_halves(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 17, 3, 64)
    pos = np.arange(17)[None, :]
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(_t(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlayers.rope_freqs(64, theta).numpy(),
                               np.asarray(jlayers.rope_freqs(64, theta)), rtol=1e-6)


def test_ffn_matches_reference():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 9, 32)
    p = {k: _rand(rng, *s, scale=0.1) for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    want = jlayers.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tlayers.ffn(params_from_numpy(p), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,qk_norm", [(0, False), (5, False), (0, True)])
def test_attention_matches_reference(window, qk_norm):
    cfg = dataclasses.replace(jreduced(jget_config("qwen2-0.5b")),
                              sliding_window=window, qk_norm=qk_norm)
    jspec = jattn_spec(cfg)
    jp = jattn.init_attention(jax.random.key(4), cfg.d_model, jspec, jnp.float32)
    jp = {k: (v + 0.05 if k.startswith("b") or k.endswith("norm") else v)
          for k, v in jp.items()}
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 24, cfg.d_model)
    want = jattn.multi_head_attention(jp, jnp.asarray(x), jspec)
    tspec = tattn.AttnSpec(**dataclasses.asdict(jspec))
    got = tattn.multi_head_attention(
        params_from_numpy(jax.tree.map(np.asarray, jp)), _t(x), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_block_mask_matches_reference():
    for spec_kw in (dict(), dict(sliding_window=3), dict(prefix_len=4),
                    dict(causal=False)):
        jspec = jattn.AttnSpec(num_heads=2, num_kv_heads=1, head_dim=16, **spec_kw)
        tspec = tattn.AttnSpec(num_heads=2, num_kv_heads=1, head_dim=16, **spec_kw)
        want = jattn._block_mask(jnp.arange(9), jnp.arange(11), jspec)
        got = tattn._block_mask(torch.arange(9), torch.arange(11), tspec)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attn_spec_matches_reference():
    jcfg, tcfg = jget_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    assert dataclasses.asdict(tattn_spec(tcfg)) == dataclasses.asdict(jattn_spec(jcfg))


def _bridged(seed=0, dtype="float32"):
    jcfg = dataclasses.replace(jreduced(jget_config("qwen2-0.5b")), dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), dtype=dtype)
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jparams = jm.init(jax.random.key(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, tm, jparams, tparams


def _batch(vocab=256, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_loss_and_grads_match_reference():
    jm, tm, jparams, tparams = _bridged()
    batch = _batch()
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(tparams)]
    tloss, tmet = tm.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["xent"]), float(jmet["xent"]), rtol=1e-5)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    for tg, jg in zip(tgrads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_forward_logits_match_reference():
    jm, tm, jparams, tparams = _bridged(seed=1)
    batch = _batch(seed=1)
    want = jm.forward(jparams, {"tokens": jnp.asarray(batch["tokens"])})
    with torch.no_grad():
        got = tm.forward(tparams, {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_padded_vocab_logits_are_masked():
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), vocab_size=1000)
    m = tmodel.build_model(cfg)
    params = m.init(device="cpu", seed=0)
    assert params["embedding"].shape == (1024, cfg.d_model)
    with torch.no_grad():
        logits = m.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert torch.all(logits[..., 1000:] == -1e30)
    assert torch.all(logits[..., :1000] > -1e3)


def test_sequence_xent_chunks_match_reference():
    """S = 2 * XENT_CHUNK takes the chunked path in both packages."""
    jm, tm, jparams, tparams = _bridged(seed=2)
    rng = np.random.default_rng(5)
    h = _rand(rng, 1, 2 * tmodel.XENT_CHUNK, 256)
    labels = rng.integers(0, 1024, size=(1, 2 * tmodel.XENT_CHUNK)).astype(np.int32)
    want = jmodel._sequence_xent(jparams, jnp.asarray(h), jnp.asarray(labels), jm.cfg)
    got = tmodel._sequence_xent(tparams, _t(h), torch.from_numpy(labels), tm.cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_bf16_loss_matches_reference_within_bf16_rounding():
    """bf16 params: the two frameworks round at other places, so the
    loss agrees to bf16's ~3 significant digits, not f32's."""
    jm, tm, jparams, tparams = _bridged(seed=3, dtype="bfloat16")
    batch = _batch(seed=3)
    jloss, _ = jm.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss, _ = tm.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)


def test_init_shapes_and_dtypes_match_reference():
    jm, tm, jparams, _ = _bridged()
    tparams = tm.init(device="cpu", seed=0)
    jl = jax.tree_util.tree_leaves(jparams)
    tl = tree_leaves(tparams)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    assert all(a.dtype == torch.float32 for a in tl)
    # zero-initialised norms and biases, as in the reference
    assert torch.count_nonzero(tparams["final_norm"]) == 0
    assert torch.count_nonzero(tparams["layers"]["attn"]["bq"]) == 0
    # same init scale as the reference (different random numbers)
    for name in ("wq", "wo"):
        js = float(np.std(np.asarray(jparams["layers"]["attn"][name])))
        ts = float(tparams["layers"]["attn"][name].std())
        assert abs(ts / js - 1) < 0.05
    back = params_to_numpy(params_from_numpy(jax.tree.map(np.asarray, jparams)))
    for a, b in zip(jax.tree_util.tree_leaves(back), jl):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_unported_families_raise():
    """No family is left unported: ``get_config`` resolves all ten of the
    reference's ids (and ``build_model`` builds each, reduced), while an
    unknown name still raises."""
    from repro.configs.base import ARCH_IDS as JARCH_IDS, get_config as jget_config

    for arch in JARCH_IDS:
        cfg = get_config(arch)
        assert cfg == dataclasses.replace(cfg, **{
            f.name: getattr(jget_config(arch), f.name) for f in dataclasses.fields(cfg)})
        assert tmodel.build_model(reduced(cfg)).cfg.arch_type == cfg.arch_type
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("whisper-large")
