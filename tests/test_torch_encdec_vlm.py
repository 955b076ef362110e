"""The port's last two families held against the reference on bridged
weights (reduced configs, the CPU): the encoder-decoder (whisper-base:
LayerNorm blocks, learned positions, cross-attention over stub audio
frames) and the VLM (paligemma-3b: a bidirectional prefix of stub image
embeddings, gemma's embedding scale, GeGLU with the tanh GELU).

Per config: fields and ``param_count``, the param tree and FlatBuffer
layout (reduced and full, meta against ``jax.eval_shape``), logits, loss
and packed grads, three train steps against ``jax.jit`` of the
reference's step, teacher-forced serve steps and the cache trees (the
enc-dec's ``{"self", "enc"}``), greedy ``BatchedServer`` tokens, a bf16
band; the VLM's staged grads ``==`` its monolithic grads; whisper refuses
overlap with the reference's message.

Tolerances are the dense family's (``tests/_torch_families.py``): f32
rtol 1e-4 / atol 1e-5 for logits and serve steps, rtol 1e-5 of each
entry or of the largest for the loss and packed grads, rtol 1e-4 for
train-step losses, the 0.04 bf16 band.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.core.comm import CollectivePolicy as JCollectivePolicy  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSyncConfig  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jlayers, model as jmodel, transformer as jtfm  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.comm import CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers, model as tmodel, transformer as ttfm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

import _torch_families as fam  # noqa: E402

torch.set_num_threads(2)

NAMES = ["whisper-base", "paligemma-3b"]
#: the reference's param_count at full size and reduced
COUNTS = {"whisper-base": (97_267_712, 3_147_776),
          "paligemma-3b": (2_508_791_808, 1_377_280)}
#: (batch, total sequence) of the loss and train-step checks: the VLM's
#: 48 are its 16 image tokens and 32 text tokens
B, S = 2, 48


def _batch(cfg, seed):
    """A batch of ``input_specs``' keys from a seeded numpy generator
    (``tests/test_archs_smoke.py``'s recipe): tokens and labels over the
    vocab, stub image / audio-frame embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)
    text = S - cfg.num_image_tokens
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)}
    if cfg.num_image_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        b["audio_frames"] = rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v.copy()) for k, v in b.items()})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_gelu_ffn_and_mlp_ffn_match_reference_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh approximation; ``F.gelu`` to
    the exact erf, which would be ~1e-4 off here."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 32)) * 2).astype(np.float32)
    w = {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in
         (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32)))}
    jw, tw = {k: jnp.asarray(v) for k, v in w.items()}, params_from_numpy(w)
    tx = torch.from_numpy(x)
    for jf, tf, keys in ((jlayers.gelu_ffn, tlayers.gelu_ffn, ("w_gate", "w_up", "w_down")),
                         (jlayers.mlp_ffn, tlayers.mlp_ffn, ("w_up", "w_down"))):
        want = np.asarray(jf({k: jw[k] for k in keys}, jnp.asarray(x)))
        got = tf({k: tw[k] for k in keys}, tx).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = (torch.nn.functional.gelu(tx @ tw["w_up"]) @ tw["w_down"]).numpy()
    assert np.abs(erf - np.asarray(jlayers.mlp_ffn(
        {k: jw[k] for k in ("w_up", "w_down")}, jnp.asarray(x)))).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 64)) * 4 + 2).astype(np.float32)
    s, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(s),
                                         jnp.asarray(b))).astype(np.float32)
    got = tlayers.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(s), torch.from_numpy(b)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kw", [dict(), dict(causal=False), dict(cross=True),
                                dict(prefix_len=16)])
def test_attn_specs_equal_reference(name, kw):
    j = jtfm.attn_spec(jbase.get_config(name), **kw)
    t = ttfm.attn_spec(tbase.get_config(name), **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_vlm_embedding_scale_rounds_in_the_activation_dtype():
    """gemma's ``sqrt(d_model)`` rounded to bf16 before the product, as
    ``jnp.asarray(d ** 0.5, x.dtype)`` is: equal bits."""
    jcfg = jbase.get_config("paligemma-3b")
    tcfg = tbase.get_config("paligemma-3b")
    rng = np.random.default_rng(2)
    emb = (rng.standard_normal((64, jcfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(0, 64, (2, 9)).astype(np.int32)
    want = jmodel._embed({"embedding": jnp.asarray(emb, jnp.bfloat16)}, jnp.asarray(toks), jcfg)
    got = tmodel._embed({"embedding": torch.from_numpy(emb).bfloat16()},
                        torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy(got), np.asarray(want))


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_config_reduced_and_counts_equal_reference(name):
    j, t = jbase.get_config(name), tbase.get_config(name)
    tf = fam.fields(t)
    assert {k: v for k, v in fam.fields(j).items() if k in tf} == tf
    assert fam.fields(tbase.reduced(t)) == {
        k: v for k, v in fam.fields(jbase.reduced(j)).items() if k in tf}
    assert t.is_enc_dec == j.is_enc_dec == (name == "whisper-base")
    assert (t.param_count(), tbase.reduced(t).param_count()) == COUNTS[name]
    assert (j.param_count(), jbase.reduced(j).param_count()) == COUNTS[name]
    assert t.active_param_count() == j.active_param_count()


def test_get_config_covers_the_reference_ids():
    assert tbase.list_configs() == jbase.list_configs() == tbase.ARCH_IDS
    for arch in tbase.ARCH_IDS:
        assert tbase.get_config(arch).name == jbase.get_config(arch).name
        assert tmodel.build_model(tbase.reduced(tbase.get_config(arch))).cfg.arch_type \
            == jbase.get_config(arch).arch_type


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_param_tree_and_layout_equal_reference(name, full):
    meta = fam.check_tree_and_layout(name, full)
    if name == "whisper-base":
        assert tuple(meta["dec_pos"]["pos_embedding"].shape)[0] == \
            tmodel.MAX_WHISPER_POSITIONS == jmodel.MAX_WHISPER_POSITIONS


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", list(jbase.INPUT_SHAPES))
def test_input_specs_match_reference(name, shape):
    jm = jmodel.build_model(jbase.get_config(name))
    tm = tmodel.build_model(tbase.get_config(name))
    want = jm.input_specs(jbase.INPUT_SHAPES[shape])
    got = tm.input_specs(tbase.INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape and got[k].device.type == "meta"
        assert str(got[k].dtype).replace("torch.", "") == str(a.dtype)


def test_bridge_round_trips_the_enc_dec_tree_bit_for_bit():
    """Whisper's nested tree (``enc_pos`` / ``dec_pos`` subtrees, stacked
    encoder and decoder) in bf16 through numpy and back."""
    jm, tm, jp, tp = fam.bridged("whisper-base", dtype="bfloat16")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()
    assert sorted(tp) == sorted(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))


# ---------------------------------------------------------------------------
# forward, loss, grads, train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_logits_loss_and_packed_grads_match_reference(name):
    jm, tm, jp, tp = fam.bridged(name)
    jb, tb = _both(_batch(jm.cfg, 0))
    want = np.asarray(jax.jit(jm.forward)(jp, jb))
    with torch.no_grad():
        got = tm.forward(tp, tb).numpy()
    assert got.shape == want.shape == (B, S, jm.cfg.padded_vocab)
    V = jm.cfg.vocab_size
    np.testing.assert_allclose(got[..., :V], want[..., :V], rtol=fam.RTOL, atol=fam.ATOL)
    assert V == jm.cfg.padded_vocab  # the reduced vocab (1024) pads nothing
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jb)
    loss, met, grads = ttrain.make_grad_fn(tm)(tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(met) == sorted(jmet)
    want_g = np.asarray(jflatbuf.spec_for(jg).pack(jg))
    np.testing.assert_allclose(ttrain.grad_spec(tm).pack(grads).numpy(), want_g,
                               rtol=1e-5, atol=1e-5 * float(np.abs(want_g).max()))


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_reference(name):
    """Three momentum-SGD steps (the fused flat path) on batches made from
    ``input_specs``' keys, as the reference's CLI feeds neither family."""
    jm, tm, jp, tp = fam.bridged(name)
    jopt = fam.jsgd.get_optimizer("sgd", lr=0.1, momentum=0.9)
    jstate = jtrain.make_train_state(jm, jopt, JSyncConfig(), jax.random.key(0))
    jstate["params"] = jax.tree.map(jnp.asarray, jp)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt, JSyncConfig(), None))
    opt = fam.tsgd.get_optimizer("sgd", lr=0.1, momentum=0.9)
    state = ttrain.make_train_state(tm, opt, SyncConfig(), device="cpu")
    state["params"] = tp
    step = ttrain.make_train_step(tm, opt, SyncConfig(), device="cpu")
    want, got = [], []
    for i in range(3):
        jb, tb = _both(_batch(jm.cfg, 10 + i))
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, tb)
        want.append(float(jmet["loss"]))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=fam.RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("buckets", [1, 3, 4])
def test_vlm_staged_grads_equal_monolithic(buckets):
    """The VLM's stage chain (image embeddings entering with the token
    embeddings, the prefix reaching every layer slice, the head dropping
    the image positions) gives the monolithic loss and grads bit for bit,
    and the reference's loss."""
    jm, tm, jp, tp = fam.bridged("paligemma-3b")
    jb, tb = _both(_batch(tm.cfg, 3))
    loss, _, grads = ttrain.make_grad_fn(tm)(tp, tb)
    stages = tm.overlap_stages(buckets)
    parts = [tree_map(lambda a: a.detach().requires_grad_(True), s)
             for s in stages.stage(tp)]
    carry = stages.fns[0](parts[0], tb)
    for s in range(1, stages.num_stages):
        carry = stages.fns[s](parts[s], carry, tb)
    staged_loss, _ = carry
    leaves = [leaf for part in parts for leaf in tree_leaves(part)]
    g = torch.autograd.grad(staged_loss, leaves, materialize_grads=True)
    assert float(staged_loss.detach()) == float(loss)
    jstages = jm.overlap_stages(buckets)
    assert stages.num_stages == jstages.num_stages
    it = iter(g)
    staged = stages.unstage(tuple(tree_map(lambda _: next(it), part)
                                  for part in parts))
    for a, b in zip(tree_leaves(staged), tree_leaves(grads)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(staged_loss), float(jax.jit(jm.loss_fn)(jp, jb)[0]),
                               rtol=1e-5)


def test_whisper_publishes_no_overlap_stages():
    """As in the reference; the overlapped step refuses it with the
    reference's message."""
    jm = jmodel.build_model(jbase.reduced(jbase.get_config("whisper-base")))
    tm = tmodel.build_model(tbase.reduced(tbase.get_config("whisper-base")))
    assert jm.overlap_stages is None and tm.overlap_stages is None
    sync = SyncConfig(policy=CollectivePolicy(method="ring", overlap=True))
    jsync = JSyncConfig(policy=JCollectivePolicy(method="ring", overlap=True))
    with pytest.raises(ValueError) as want:
        jtrain.overlap_schedule(jm, jsync, 1)
    with pytest.raises(ValueError) as got:
        ttrain.overlap_schedule(tm, sync, 1)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_serve_steps_and_cache_match_reference(name):
    """Twelve teacher-forced serve steps; the enc-dec cache's ``"enc"``
    stays the zeros ``init_cache`` made (nothing fills it, as in the
    reference) and passes through every step as the same tensor."""
    tc = fam.check_serve_steps(name)
    if name == "whisper-base":
        assert sorted(tc) == ["enc", "self"]
        assert int(torch.count_nonzero(tc["enc"])) == 0
        tm = tmodel.build_model(tbase.reduced(tbase.get_config(name)))
        cache = tm.init_cache(2, 8, "cpu")
        enc = cache["enc"]
        _, cache = tm.serve_step(tm.init(device="cpu"), cache,
                                 torch.zeros((2, 1), dtype=torch.int32))
        assert cache["enc"] is enc
        assert cache["self"]["index"].tolist() == [1] * tm.cfg.num_layers


@pytest.mark.parametrize("name", NAMES)
def test_batched_server_greedy_tokens_equal_reference(name):
    srv = fam.check_greedy(name)
    if name == "whisper-base":
        assert sorted(srv.cache) == ["enc", "self"]


@pytest.mark.parametrize("name", NAMES)
def test_serve_step_bf16_within_band(name):
    assert fam.check_serve_bf16(name) <= 0.04


def test_whisper_decode_cross_attends_the_cache_enc():
    """With ``enc`` set to an encoder output (random here; the server never
    sets it), every decode step cross-attends to it as the reference's
    does: logits and the self-attention cache."""
    jm, tm, jp, tp = fam.bridged("whisper-base")
    cfg = jm.cfg
    enc = np.random.default_rng(4).standard_normal(
        (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    jc = dict(jm.init_cache(2, 16), enc=jnp.asarray(enc))
    tc = tm.init_cache(2, 16, "cpu")
    tc["enc"].copy_(torch.from_numpy(enc))
    jstep = jax.jit(jm.serve_step)
    toks = fam.tokens(cfg, 2, 8, seed=4)
    for t in range(toks.shape[1]):
        want, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, tc = tm.serve_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=fam.RTOL,
                                   atol=fam.ATOL, err_msg=f"step {t}")
    fam.check_cache_tree(jc, tc, fam.RTOL, fam.ATOL)
