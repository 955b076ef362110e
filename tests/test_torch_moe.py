"""The port's MoE family held against the reference on bridged weights:
the router's top-k, the capacity dispatch (slots and keeps exactly), the
MoE block and its dense oracle (``tests/test_models.py``'s semantics),
and reduced qwen2-moe-a2.7b / mixtral-8x7b end to end — config and param
counts, the param tree and FlatBuffer layout, loss and packed grads, three
train steps against ``jax.jit`` of the reference's step, serve steps and
cache trees, greedy ``BatchedServer`` tokens, a bf16 band, the staged
backward (``==`` the monolithic one, aux carried) and the train CLI."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core.comm import CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

import _torch_families as fam  # noqa: E402

torch.set_num_threads(2)

MOE = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
#: the reference's param_count / active_param_count at full size
COUNTS = {"qwen2-moe-a2.7b": (14_316_257_280, 2_689_646_592),
          "mixtral-8x7b": (46_702_788_608, 12_879_921_152)}


def _moe_params(E, d, f, shared, seed):
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(seed), d, E, shared, f,
                                                jnp.float32))
    return jp, params_from_numpy(jp)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# router and dispatch
# ---------------------------------------------------------------------------

def test_top_k_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` order, ties included (``torch.topk`` promises
    none)."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 8)).astype(np.float32) / 4.0   # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = tmoe._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("E, capacity", [(4, 2), (8, 3), (8, 64), (60, 1)])
def test_dispatch_slots_and_keeps_equal_reference(E, capacity):
    """Slot and keep of every (token, k) entry exactly the reference's,
    with and without capacity drops, row by row as the block's vmap."""
    assign = np.random.default_rng(E + capacity).integers(0, E, (3, 40)).astype(np.int32)
    jslot, jkeep = jax.vmap(lambda e: jmoe._dispatch_indices(e, E, capacity))(
        jnp.asarray(assign))
    slot, keep = tmoe._dispatch_indices(torch.from_numpy(assign), E, capacity)
    assert slot.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if capacity < 40 * 3 // E:
        assert not bool(keep.all())                # some entries dropped


# ---------------------------------------------------------------------------
# the MoE block (tests/test_models.py:93-146 semantics)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E, K, shared, cf, S", [
    (8, 2, 1, 1.25, 10), (4, 2, 0, 0.25, 16), (60, 4, 4, 1.25, 12), (8, 1, 0, 4.0, 9)],
    ids=["shared", "drops", "qwen2-moe-like", "top1"])
def test_moe_block_matches_reference(E, K, shared, cf, S):
    """Output and aux within rtol 1e-5 / atol 1e-6 (f32); the 0.25
    capacity factor drops tokens (capacity 2 of 8 entries per expert)."""
    d, f = 16, 24
    jp, tp = _moe_params(E, d, f, shared, seed=E + K)
    x = _x((2, S, d), 1)
    kw = dict(num_experts=E, top_k=K, capacity_factor=cf, aux_weight=0.01)
    want, jaux = jax.jit(functools.partial(jmoe.moe_block, **kw))(jp, jnp.asarray(x))
    got, aux = tmoe.moe_block(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)


def test_moe_gradients_match_reference():
    """``jax.grad`` of sum(out²) + aux against autograd's, drops included."""
    E, K, d, f = 4, 2, 8, 16
    jp, tp = _moe_params(E, d, f, 1, seed=14)
    x = _x((2, 8, d), 15)
    kw = dict(num_experts=E, top_k=K, capacity_factor=0.75, aux_weight=0.01)

    def jloss(p):
        out, aux = jmoe.moe_block(p, jnp.asarray(x), **kw)
        return jnp.sum(out ** 2) + aux

    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, jp))
    leaves = {k: v for k, v in tp.items() if k != "shared"}
    leaves["shared"] = dict(tp["shared"])
    flat = [leaves[k] for k in ("moe_down", "moe_gate", "moe_up", "router")] + [
        leaves["shared"][k] for k in ("w_down", "w_gate", "w_up")]
    for t in flat:
        t.requires_grad_(True)
    out, aux = tmoe.moe_block(leaves, torch.from_numpy(x), **kw)
    grads = torch.autograd.grad(torch.sum(out ** 2) + aux, flat)
    want = [jg[k] for k in ("moe_down", "moe_gate", "moe_up", "router")] + [
        jg["shared"][k] for k in ("w_down", "w_gate", "w_up")]
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert float(grads[1].abs().sum()) > 0


def test_moe_matches_dense_oracle_with_ample_capacity():
    """No drops at capacity factor 8: the block == every expert on every
    token (the reference's 2e-4 band), and both oracles agree."""
    E, K, d, f = 8, 2, 16, 32
    jp, tp = _moe_params(E, d, f, 1, seed=8)
    x = torch.from_numpy(_x((2, 10, d), 9))
    got, aux = tmoe.moe_block(tp, x, num_experts=E, top_k=K, capacity_factor=8.0,
                              aux_weight=0.0)
    oracle = tmoe.reference_moe(tp, x, num_experts=E, top_k=K)
    torch.testing.assert_close(got, oracle, rtol=2e-4, atol=2e-4)
    assert float(aux) == 0.0
    want = jax.jit(functools.partial(jmoe.reference_moe, num_experts=E, top_k=K))(
        jp, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_moe_aux_loss_balanced_router_lower_than_collapsed():
    E, d = 4, 8
    _, tp = _moe_params(E, d, 16, 0, seed=12)
    x = torch.from_numpy(_x((2, 32, d), 13))
    collapsed = dict(tp, router=torch.zeros_like(tp["router"]))
    collapsed["router"][:, 0] = 10.0
    kw = dict(num_experts=E, top_k=1, capacity_factor=4.0, aux_weight=1.0)
    _, aux_bal = tmoe.moe_block(tp, x, **kw)
    _, aux_col = tmoe.moe_block(collapsed, x, **kw)
    assert float(aux_col) > float(aux_bal)


# ---------------------------------------------------------------------------
# the two configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_config_reduced_and_counts_equal_reference(name):
    j, t = jbase.get_config(name), tbase.get_config(name)
    for jc, tc in ((j, t), (jbase.reduced(j), tbase.reduced(t))):
        jf = fam.fields(jc)
        for field, value in fam.fields(tc).items():
            assert value == jf[field], field
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert (t.param_count(), t.active_param_count()) == COUNTS[name]


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", MOE)
def test_param_tree_and_layout_equal_reference(name, full):
    meta = fam.check_tree_and_layout(name, full)
    cfg = build_model(tbase.get_config(name)).cfg
    if full:   # the tree adds the final norm's scale the formula leaves out
        assert fam.param_numel(meta) == cfg.param_count() + cfg.d_model


@pytest.mark.parametrize("name", MOE)
def test_loss_and_packed_grads_match_reference(name):
    """xent + aux and both metrics, and the packed gradient (rtol 1e-5)."""
    jm, loss = fam.check_loss_and_grads(name, rtol=1e-5)
    assert np.isfinite(loss)


@pytest.mark.parametrize("name", MOE)
def test_train_steps_match_reference(name):
    assert np.all(np.isfinite(fam.check_train_steps(name)))


@pytest.mark.parametrize("name", MOE)
def test_serve_steps_and_cache_match_reference(name):
    """Twelve teacher-forced decode steps (decode's deterministic capacity
    never drops) and the KV cache tree."""
    cache = fam.check_serve_steps(name)
    assert cache["index"].tolist() == [12, 12]


@pytest.mark.parametrize("name", MOE)
def test_batched_server_greedy_tokens_equal_reference(name):
    srv = fam.check_greedy(name)
    assert srv.cache["index"].tolist() == [6 + 8] * 2


def test_serve_step_bf16_within_band():
    """Reduced qwen2-moe in bf16 (untied lm_head: logits reach |4|, where
    one bf16 ulp is 2^-5); measured ≤ 0.012 of that scale."""
    assert fam.check_serve_bf16("qwen2-moe-a2.7b") < 0.04


def _overlap_sync(buckets):
    return SyncConfig(mode="mpi_sgd", policy=CollectivePolicy(
        method="ring", num_rings=1, overlap=True, overlap_buckets=buckets))


@pytest.mark.parametrize("buckets", [4, 3])
def test_staged_grads_equal_monolithic(buckets):
    """Reduced qwen2-moe under the overlap schedule: the loss, the xent
    and the aux the stages carry, and the packed staged gradient ``==``
    the monolithic ones."""
    model = build_model(tbase.reduced(tbase.get_config("qwen2-moe-a2.7b")))
    stages, sched = ttrain.overlap_schedule(model, _overlap_sync(buckets), 1)
    assert stages.num_stages == min(buckets, model.cfg.num_layers + 2)
    params = model.init(device="cpu", seed=1)
    toks = fam.tokens(model.cfg, 4, 24, seed=3)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    gfn = ttrain.make_overlap_grad_fn(model, stages, sched, tcomm.LOCAL)
    loss_o, met_o, g_shard = gfn(params, batch)
    loss_m, met_m, grads = ttrain.make_grad_fn(model)(params, batch)
    assert float(loss_o) == float(loss_m)
    assert float(met_o["aux"]) == float(met_m["aux"]) > 0
    assert float(met_o["xent"]) == float(met_m["xent"])
    assert torch.equal(g_shard, sched.spec.pack(stages.stage(grads)))


@pytest.mark.parametrize("name", MOE)
def test_train_cli_runs_the_arch(name, capsys):
    hist = ttrain.main(["--device", "cpu", "--steps", "2", "--arch", name])
    out = capsys.readouterr().out
    assert f"arch={name}" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
