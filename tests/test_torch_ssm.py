"""The port's SSM (mamba2) and hybrid (zamba2) families held against the
reference on bridged weights: the chunked SSD against the JAX function
and the sequential oracle, state carrying, the causal conv, the Mamba2
block and its decode (``tests/test_models.py``'s semantics), the hybrid's
shared block with a nonzero LoRA delta, and reduced mamba2-130m /
zamba2-1.2b end to end — config and param counts, the param tree and
FlatBuffer layout, loss and packed grads, three train steps against
``jax.jit`` of the reference's step, serve steps and the state-cache
trees, greedy ``BatchedServer`` tokens, a bf16 band, the refused
``--overlap`` and the train CLI."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.comm import CollectivePolicy as JPolicy  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSyncConfig  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import ssm as jssm, transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.comm import CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as tssm, transformer as ttfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

import _torch_families as fam  # noqa: E402

torch.set_num_threads(2)

SSM = ["mamba2-130m", "zamba2-1.2b"]
#: the reference's param_count at full size (active == all)
COUNTS = {"mamba2-130m": 129_055_872, "zamba2-1.2b": 1_179_746_048}
# f32 against the JAX function: the same products in other orders
RTOL, ATOL = 1e-5, 1e-5


def _ssd_inputs(B, L, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# SSD (tests/test_models.py:148-182 semantics)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(32, 8), (33, 8), (16, 16), (40, 64)])
def test_ssd_chunked_matches_reference_and_recurrent(L, chunk):
    """Against the JAX function (f32 tolerance) and against the sequential
    oracle (the reference's 1e-3 band); L = 33 and 40 pad the last chunk."""
    inputs = _ssd_inputs(2, L, 3, 4, 8, seed=L + chunk)
    y, h = tssm.ssd_chunked(*_t(*inputs), chunk)
    jy, jh = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk))(*_j(*inputs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    yr, hr = tssm.ssd_recurrent_ref(*_t(*inputs))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=1e-3, atol=1e-3)
    jyr, jhr = jax.jit(jssm.ssd_recurrent_ref)(*_j(*inputs))
    np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hr.numpy(), np.asarray(jhr), rtol=RTOL, atol=ATOL)


def test_ssd_initial_state_carrying():
    """Prefill-then-continue == one long sequence (the state handoff), and
    the continued half == the reference's with the same h0."""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 24, 2, 4, 8, seed=17)
    A = -np.ones(2, np.float32)
    y_full, h_full = tssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=8)
    half = 12
    first = [a[:, :half] for a in (x, dt)] + [A] + [a[:, :half] for a in (Bm, Cm)]
    rest = [a[:, half:] for a in (x, dt)] + [A] + [a[:, half:] for a in (Bm, Cm)]
    y1, h1 = tssm.ssd_chunked(*_t(*first), chunk=8)
    y2, h2 = tssm.ssd_chunked(*_t(*rest), chunk=8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=1e-3, atol=1e-3)
    jy2, jh2 = jax.jit(functools.partial(jssm.ssd_chunked, chunk=8))(
        *_j(*rest), h0=jnp.asarray(h1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=RTOL, atol=ATOL)


def test_ssd_gradients_are_finite_and_match_reference():
    """``_segsum`` masks with -inf before the exp, so the upper triangle's
    large positive sums give no inf·0 = NaN in backward."""
    inputs = _ssd_inputs(2, 40, 3, 4, 8, seed=5)
    inputs = (inputs[0], inputs[1] * 8.0) + inputs[2:]   # large |dA| sums

    def jloss(x, dt, A, Bm, Cm):
        y, h = jssm.ssd_chunked(x, dt, A, Bm, Cm, 16)
        return jnp.sum(y ** 2) + jnp.sum(h)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*_j(*inputs))
    ts = [t.requires_grad_(True) for t in _t(*inputs)]
    y, h = tssm.ssd_chunked(*ts, 16)
    grads = torch.autograd.grad(torch.sum(y ** 2) + torch.sum(h), ts)
    for g, w in zip(grads, jg):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_ssd_decode_step_matches_reference():
    x, dt, A, Bm, Cm = _ssd_inputs(2, 1, 3, 4, 8, seed=9)
    h0 = np.random.default_rng(10).standard_normal((2, 3, 4, 8)).astype(np.float32)
    args = (h0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    y, h = tssm.ssd_decode_step(*_t(*args))
    jy, jh = jssm.ssd_decode_step(*_j(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# causal conv and the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    """K shifted products summed in index order in the activation dtype:
    exact in f32 up to silu's ulp, within one bf16 ulp in bf16."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = np.asarray(jax.jit(jssm.causal_conv)(*[jnp.asarray(a, jd) for a in (x, w, b)]),
                      np.float32)
    td = getattr(torch, dtype)
    got = tssm.causal_conv(*[torch.from_numpy(a).to(td) for a in (x, w, b)]).float()
    tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _mamba_params(d, kw, seed):
    jp = jax.tree.map(np.asarray, jssm.init_mamba(
        jax.random.key(seed), d, conv_width=4, dtype=jnp.float32, **kw))
    rng = np.random.default_rng(seed)
    jp = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in jp.items()}
    return jp, params_from_numpy(jp)


def test_mamba_block_and_decode_match_reference():
    """``mamba_block`` over a sequence == the reference's block (f32
    tolerance) and == ``mamba_decode`` token by token (the reference's
    2e-3 band); the final ssm / conv states == the decode's."""
    d, B, L = 16, 2, 6
    kw = dict(expand=2, head_dim=8, state=8)
    jp, tp = _mamba_params(d, kw, seed=18)
    x = (np.random.default_rng(19).standard_normal((B, L, d)) * 0.5).astype(np.float32)
    full, (h_full, conv_full) = tssm.mamba_block(tp, torch.from_numpy(x), chunk=4, **kw)
    jfull, (jh, jconv) = jax.jit(functools.partial(jssm.mamba_block, chunk=4, **kw))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(conv_full.numpy(), np.asarray(jconv), rtol=0, atol=0)
    h, conv = tssm.init_mamba_state(B, d, conv_width=4, dtype=torch.float32,
                                    device="cpu", **kw)
    jh_, jconv_ = jssm.init_mamba_state(B, d, conv_width=4, dtype=jnp.float32, **kw)
    assert tuple(h.shape) == jh_.shape and tuple(conv.shape) == jconv_.shape
    outs = []
    for t in range(L):
        o, (h, conv) = tssm.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]), h, conv, **kw)
        jo, (jh_, jconv_) = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jh_,
                                              jconv_, **kw)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(conv.numpy(), conv_full.numpy(), rtol=RTOL, atol=1e-6)


def test_mamba_block_continues_from_states():
    """A prefix's (h, conv) states carried into the rest: == one pass."""
    d, kw = 16, dict(expand=2, head_dim=8, state=8)
    _, tp = _mamba_params(d, kw, seed=20)
    x = torch.from_numpy((np.random.default_rng(21).standard_normal((1, 11, d)) * 0.5
                          ).astype(np.float32))
    full, (hf, cf) = tssm.mamba_block(tp, x, chunk=4, **kw)
    a, (h1, c1) = tssm.mamba_block(tp, x[:, :5], chunk=4, **kw)
    b, (h2, c2) = tssm.mamba_block(tp, x[:, 5:], chunk=4, h0=h1, conv0=c1, **kw)
    torch.testing.assert_close(torch.cat([a, b], 1), full, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(h2, hf, rtol=1e-4, atol=1e-5)
    assert torch.equal(c2, cf)


def test_shared_attn_with_lora_matches_reference():
    """The hybrid's shared block with a nonzero LoRA pair on wq."""
    jcfg = jbase.reduced(jbase.get_config("zamba2-1.2b"))
    tcfg = tbase.reduced(tbase.get_config("zamba2-1.2b"))
    jm, tm, jp, tp = fam.bridged("zamba2-1.2b")
    assert float(np.abs(jp["lora"]["lora_b_q"][1]).max()) > 0
    x = (np.random.default_rng(22).standard_normal((2, 10, jcfg.d_model)) * 0.5
         ).astype(np.float32)
    lora_j = jax.tree.map(lambda a: a[1], jp["lora"])
    want = jax.jit(functools.partial(jtfm._shared_attn, cfg=jcfg))(
        jp["shared"], lora_j, jnp.asarray(x))
    got = ttfm._shared_attn(tp["shared"], {k: v[1] for k, v in tp["lora"].items()},
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    zero = {k: torch.zeros_like(v[1]) if k == "lora_b_q" else v[1]
            for k, v in tp["lora"].items()}
    plain = ttfm._shared_attn(tp["shared"], zero, torch.from_numpy(x), tcfg)
    assert float((got - plain).abs().max()) > 1e-3      # the delta is live


# ---------------------------------------------------------------------------
# the two configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SSM)
def test_config_reduced_and_counts_equal_reference(name):
    """Field for field (full and reduced); param_count as the reference
    writes it — for the hybrid its LoRA term counts three (q, k, v) pairs
    per invocation, the params hold the q pair only."""
    j, t = jbase.get_config(name), tbase.get_config(name)
    for jc, tc in ((j, t), (jbase.reduced(j), tbase.reduced(t))):
        jf = fam.fields(jc)
        for field, value in fam.fields(tc).items():
            assert value == jf[field], field
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count() == jc.param_count()
        assert tc.supports_long_decode == jc.supports_long_decode
        assert tc.is_attention_free == jc.is_attention_free
    assert t.param_count() == COUNTS[name]


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", SSM)
def test_param_tree_and_layout_equal_reference(name, full):
    fam.check_tree_and_layout(name, full)


@pytest.mark.parametrize("name", SSM)
def test_loss_and_packed_grads_match_reference(name):
    _, loss = fam.check_loss_and_grads(name, rtol=1e-5)
    assert np.isfinite(loss)


@pytest.mark.parametrize("name", SSM)
def test_train_steps_match_reference(name):
    assert np.all(np.isfinite(fam.check_train_steps(name)))


@pytest.mark.parametrize("name", SSM)
def test_serve_steps_and_cache_match_reference(name):
    """Twelve teacher-forced decode steps; the ``h`` / ``conv`` state
    cache (and the hybrid's per-invocation KV cache) as the reference's
    tree, written in place."""
    cache = fam.check_serve_steps(name)
    if name == "zamba2-1.2b":
        assert cache["attn"]["index"].tolist() == [12, 12]


def test_serve_step_writes_the_state_cache_in_place():
    model = build_model(tbase.reduced(tbase.get_config("zamba2-1.2b")))
    params = model.init(device="cpu", seed=0)
    cache = model.init_cache(2, 8, "cpu")
    before = {k: cache["mamba"][k] for k in ("h", "conv")}
    k = cache["attn"]["k"]
    logits, new = model.serve_step(params, cache, torch.tensor([[3], [5]], dtype=torch.int32))
    assert new["mamba"]["h"] is before["h"] and new["mamba"]["conv"] is before["conv"]
    assert new["attn"]["k"] is k and bool(before["h"].abs().sum() > 0)
    assert new["attn"]["index"].tolist() == [1, 1] and not logits.requires_grad


@pytest.mark.parametrize("name", SSM)
def test_batched_server_greedy_tokens_equal_reference(name):
    fam.check_greedy(name)


def test_serve_step_bf16_within_band():
    """Reduced mamba2 in bf16 (tied embedding: logits ≤ |1.4|, as the
    dense case's); measured ≤ 0.018 of the scale."""
    assert fam.check_serve_bf16("mamba2-130m") < 0.04


def test_overlap_is_refused_like_reference():
    """The SSM family publishes no staged backward, as in the reference:
    --overlap is refused with the reference's message."""
    jm = jbuild_model(jbase.reduced(jbase.get_config("mamba2-130m")))
    tm = build_model(tbase.reduced(tbase.get_config("mamba2-130m")))
    assert jm.overlap_stages is None and tm.overlap_stages is None
    with pytest.raises(ValueError) as jerr:
        jtrain.overlap_schedule(jm, JSyncConfig(policy=JPolicy(
            method="ring", num_rings=1, overlap=True)), 1)
    with pytest.raises(ValueError) as terr:
        ttrain.overlap_schedule(tm, SyncConfig(policy=CollectivePolicy(
            method="ring", num_rings=1, overlap=True)), 1)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not publish overlap_stages"):
        ttrain.main(["--device", "cpu", "--steps", "1", "--arch", "mamba2-130m",
                     "--overlap"])


@pytest.mark.parametrize("name", SSM)
def test_train_cli_runs_the_arch(name, capsys):
    hist = ttrain.main(["--device", "cpu", "--steps", "2", "--arch", name])
    assert f"arch={name}" in capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_input_specs_match_reference():
    for name in SSM + ["qwen2-moe-a2.7b"]:
        jm = jbuild_model(jbase.get_config(name))
        tm = build_model(tbase.get_config(name))
        for shape in jbase.INPUT_SHAPES:
            want = jm.input_specs(jbase.INPUT_SHAPES[shape])
            got = tm.input_specs(tbase.INPUT_SHAPES[shape])
            assert sorted(got) == sorted(want)
            for k, spec in want.items():
                assert got[k].device.type == "meta" and tuple(got[k].shape) == spec.shape


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "mixtral-8x7b", "mamba2-130m",
                                  "zamba2-1.2b"])
def test_list_configs_and_epoch_time_see_the_families(name):
    """The four ids in ``list_configs`` at the reference's positions, and
    Fig. 12's epoch time at each family's f32 model bytes."""
    from repro.core import cost_model as jcost
    from repro_torch.core import cost_model as tcost

    arch = name.replace("-", "_").replace(".", "_")
    ported = tbase.list_configs()
    assert arch in ported and ported == [a for a in jbase.list_configs() if a in ported]
    nbytes = 4 * tbase.get_config(name).param_count()
    for kw in (dict(mode="mpi", num_workers=8, num_clients=2, num_servers=1),
               dict(mode="dist", num_workers=4, num_clients=4, num_servers=2)):
        common = dict(model_bytes=nbytes, steps_per_epoch=100, compute_time_per_step=0.5)
        assert tcost.epoch_time(net=tcost.testbed(), **common, **kw) == \
            jcost.epoch_time(net=jcost.testbed(), **common, **kw)
