"""Shared checks for the port's MoE, SSM and hybrid families held against
the reference on bridged weights (reduced configs, the CPU): the param
tree and FlatBuffer layout, the loss and its packed gradient, three
``make_train_step`` steps against ``jax.jit`` of the reference's step,
teacher-forced serve steps with their cache trees, and the greedy
``BatchedServer`` against the reference's server."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget_config, reduced as jreduced
from repro.core import flatbuf as jflatbuf
from repro.core.hierarchy import SyncConfig as JSyncConfig
from repro.data.pipeline import DataConfig as JDataConfig, TokenPipeline as JTokenPipeline
from repro.launch import train as jtrain
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.models.model import build_model as jbuild_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import flatbuf
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import BatchedServer
from repro_torch.models.model import build_model
from repro_torch.tree import path_str, tree_flatten_with_path, tree_leaves

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")

# f32: the two frameworks sum the same products in other orders
RTOL, ATOL = 1e-4, 1e-5
#: seq 80 is one full 64-token SSD chunk plus a padded one (reduced)
DATA = dict(seed=0, vocab_size=256, seq_len=80, batch_size=4)


def fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


#: the leaves the reference initialises to constants (norm scales end in
#: "norm"; ``D`` starts at ones)
CONSTANT_INIT = ("bq", "bk", "bv", "conv_b", "dt_bias", "A_log", "D", "lora_b_q")


def _offset(tree, rng):
    """The constant-initialised leaves moved by 0.05·N(0, 1), so the norm
    scales, biases, conv bias, ``dt_bias``, ``A_log``, ``D`` and the LoRA
    ``b`` half (whose delta on wq starts at 0) are exercised off their
    init."""
    def move(path, a):
        key = path[-1].key
        if key in CONSTANT_INIT or key.endswith("norm"):
            return (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, tree)


def bridged(name, dtype="float32", seed=0):
    """Reduced reference and port models and one set of weights for both
    (numpy for the reference, tensors for the port)."""
    jcfg = dataclasses.replace(jreduced(jget_config(name)), dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_config(name)), dtype=dtype)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = _offset(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))),
                 np.random.default_rng(seed))
    return jm, tm, jp, params_from_numpy(jp)


def tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def check_tree_and_layout(name, full):
    """The port's shape-only params against ``jax.eval_shape`` of the
    reference's init: paths (sorted-key order), shapes, dtypes and the
    FlatBuffer layout."""
    jcfg, tcfg = jget_config(name), get_config(name)
    if not full:
        jcfg, tcfg = jreduced(jcfg), reduced(tcfg)
    jabs = jax.eval_shape(jbuild_model(jcfg).init, jax.random.key(0))
    tmeta = build_model(tcfg).init(device="meta")
    jl = jax.tree_util.tree_flatten_with_path(jabs)[0]
    tl = tree_flatten_with_path(tmeta)[0]
    assert [path_str(p) for p, _ in tl] == [
        "/".join(f"k:{k.key}" for k in p) for p, _ in jl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).replace("torch.", "") == str(a.dtype)
        assert b.device.type == "meta"
    js, ts = jflatbuf.spec_for(jabs), flatbuf.spec_for(tmeta)
    assert ts.offsets == js.offsets and ts.sizes == js.sizes
    assert ts.size == js.size and ts.payload == js.payload
    return tmeta


def check_loss_and_grads(name, rtol):
    """loss_fn and its gradient, packed through the FlatBuffer: every
    entry within ``rtol`` of itself or of the gradient's largest entry
    (an entry that cancels to near zero keeps only the latter)."""
    jm, tm, jp, tp = bridged(name)
    b = TokenPipeline(DataConfig(**dict(DATA, vocab_size=jm.cfg.vocab_size))
                      ).batch_at(0, 0)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    loss, met, grads = ttrain.make_grad_fn(tm)(tp, b)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    assert sorted(met) == sorted(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=rtol)
    spec = ttrain.grad_spec(tm)
    want = np.asarray(jflatbuf.spec_for(jg).pack(jg))
    np.testing.assert_allclose(spec.pack(grads).numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))
    return jm, float(loss)


def check_train_steps(name, steps=3):
    """``steps`` momentum-SGD steps (the fused flat path) from the same
    weights: per-step losses within rtol 1e-4 of ``jax.jit`` of the
    reference's step; returns the port's losses."""
    jm, tm, jp, tp = bridged(name)
    data = dict(DATA, vocab_size=jm.cfg.vocab_size)
    jopt, jsync = jsgd.get_optimizer("sgd", lr=0.1, momentum=0.9), JSyncConfig()
    jstate = jtrain.make_train_state(jm, jopt, jsync, jax.random.key(0))
    jstate["params"] = jax.tree.map(jnp.asarray, jp)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt, jsync, None))
    opt, sync = tsgd.get_optimizer("sgd", lr=0.1, momentum=0.9), SyncConfig()
    state = ttrain.make_train_state(tm, opt, sync, device="cpu")
    state["params"] = tp
    step = ttrain.make_train_step(tm, opt, sync, device="cpu")
    jpipe, pipe = JTokenPipeline(JDataConfig(**data)), TokenPipeline(DataConfig(**data))
    want, got = [], []
    for i in range(steps):
        jstate, jmet = jstep(jstate, jpipe.batch_at(0, i))
        state, met = step(state, pipe.batch_at(0, i))
        want.append(float(jmet["loss"]))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    return got


def teacher_forced(jm, tm, jp, tp, toks, max_seq):
    """Both serve steps over ``toks`` from empty caches: per-step logits
    of each and the final caches."""
    B, T = toks.shape
    jstep = jax.jit(jm.serve_step)
    jc, tc = jm.init_cache(B, max_seq), tm.init_cache(B, max_seq, "cpu")
    jl, tl = [], []
    for t in range(T):
        a, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        b, tc = tm.serve_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        jl.append(f32(a))
        tl.append(f32(b))
    return jl, tl, jc, tc


def check_cache_tree(jc, tc, rtol, atol, values_of=None):
    """Keys (sorted-key flatten order), shapes, dtypes and values (of the
    leaves of dtype ``values_of`` only, when given)."""
    jl = jax.tree_util.tree_flatten_with_path(jc)[0]
    tl = tree_flatten_with_path(tc)[0]
    assert [path_str(p) for p, _ in tl] == [
        "/".join(f"k:{k.key}" for k in p) for p, _ in jl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).replace("torch.", "") == str(a.dtype), path
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        elif values_of is None or str(a.dtype) == values_of:
            np.testing.assert_allclose(f32(b), f32(a), rtol=rtol, atol=atol,
                                       err_msg=jax.tree_util.keystr(path))


def check_serve_steps(name, T=12, max_seq=16):
    jm, tm, jp, tp = bridged(name)
    jl, tl, jc, tc = teacher_forced(jm, tm, jp, tp, tokens(jm.cfg, 2, T), max_seq)
    for t, (want, got) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
    check_cache_tree(jc, tc, RTOL, ATOL)
    return tc


def check_serve_bf16(name, band=0.04, T=12):
    """bf16 weights, activations and caches, the constant-initialised
    leaves moved off their init: the two frameworks round to bf16 at
    nearly the same points (XLA keeps some fused chains in f32) and sum in
    other orders. Logits within ``band`` × max(1, max |logit|): the dense
    family's 0.04 band (``tests/test_torch_serve.py``, logits ≤ |1.4|)
    scaled with the logits' bf16 ulp; the bf16 cache leaves in the same
    band. The SSM's f32 state ``h`` sums bf16-rounded terms over every
    token, so it is held by the logits it produces here (and to rtol 1e-4
    in f32 by ``check_serve_steps``). Returns the worst logit difference
    over the scale."""
    jm, tm, jp, tp = bridged(name, dtype="bfloat16", seed=1)
    jl, tl, jc, tc = teacher_forced(jm, tm, jp, tp, tokens(jm.cfg, 2, T, seed=1), 16)
    V = jm.cfg.vocab_size
    scale = max(1.0, max(float(np.abs(a[..., :V]).max()) for a in jl))
    for t, (want, got) in enumerate(zip(jl, tl)):
        np.testing.assert_allclose(got, want, rtol=0, atol=band * scale,
                                   err_msg=f"step {t}")
    check_cache_tree(jc, tc, 0, band * scale, values_of="bfloat16")
    return max(float(np.abs(a - b).max()) for a, b in zip(jl, tl)) / scale


def check_greedy(name, P=6, new=8):
    """Greedy continuation of the reference's ``BatchedServer`` and the
    port's from the same weights and prompts. Equal tokens are implied
    only where the top-1 logit leads the second by more than the logits'
    tolerance, so the reference's margin on every chosen token is
    asserted first."""
    jm, tm, jp, tp = bridged(name, seed=2)
    prompts = tokens(jm.cfg, 2, P, seed=2)
    want = np.asarray(JBatchedServer(jm, jp, batch=2, max_seq=32).generate(
        jnp.asarray(prompts), steps=new))
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    jl, _, _, _ = teacher_forced(jm, tm, jp, tp, seq, max_seq=32)
    chosen = np.concatenate(jl[P - 1:], axis=1)[..., :jm.cfg.vocab_size]
    top2 = np.sort(chosen, axis=-1)[..., -2:]
    assert float(np.min(top2[..., 1] - top2[..., 0])) > 100 * ATOL
    np.testing.assert_array_equal(np.argmax(chosen, -1), want)
    srv = BatchedServer(tm, tp, batch=2, max_seq=32, device="cpu")
    got = srv.generate(torch.from_numpy(prompts), steps=new)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    return srv


def _spec_tuples(tree, is_leaf):
    return [tuple(s) for s in tree_leaves(tree, is_leaf)]


def check_mesh_specs(name, mesh, full):
    """On ``mesh`` (anything with a ``.shape`` dict): ``param_specs``,
    ``cache_specs`` (whisper's ``enc`` among them), the train batch's
    specs (every ``input_specs`` key: ``audio_frames`` / ``image_embeds``
    among them) and ``token_specs`` equal the reference's, path by path,
    at the reduced or the full config; every one is placeable on the
    mesh."""
    from jax.sharding import PartitionSpec

    from repro.launch import serve as jserve
    from repro.sharding.rules import param_specs as jparam_specs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import serve as tserve
    from repro_torch.sharding import rules as trules

    tcfg, jcfg = get_config(name), jget_config(name)
    if not full:
        tcfg, jcfg = reduced(tcfg), jreduced(jcfg)
    tm, jm = build_model(tcfg), jbuild_model(jcfg)
    jspec = lambda x: isinstance(x, PartitionSpec)
    meta = tm.init(device="meta")
    ps = trules.param_specs(meta, mesh)
    jps = jparam_specs(jax.eval_shape(jm.init, jax.random.key(0)), mesh)
    assert _spec_tuples(ps, trules.is_spec) == _spec_tuples(jps, jspec)
    B, S = 8, 64
    cache = tm.init_cache(B, S, "meta")
    cs = tserve.cache_specs(cache, mesh)
    assert [p for p, _ in tree_flatten_with_path(cache)[0]] == [
        p for p, _ in tree_flatten_with_path(cs, is_leaf=trules.is_spec)[0]]
    jcs = jserve.cache_specs(jax.eval_shape(lambda: jm.init_cache(B, S)), mesh)
    assert _spec_tuples(cs, trules.is_spec) == _spec_tuples(jcs, jspec)
    shape = InputShape("t", 2 * tcfg.num_image_tokens + 64, B, "train")
    bs = ttrain.batch_specs(tm, shape, mesh, SyncConfig(fused_update=False))
    jbs = jtrain.batch_specs(jm, shape, mesh, JSyncConfig(fused_update=False))
    assert sorted(bs) == sorted(jbs) == sorted(tm.input_specs(shape))
    assert {k: tuple(v) for k, v in bs.items()} == {k: tuple(v) for k, v in jbs.items()}
    assert tuple(tserve.token_specs((B, 1), mesh)) == tuple(jserve.token_specs((B, 1), mesh))
    for spec in (tree_leaves(ps, trules.is_spec) + tree_leaves(cs, trules.is_spec)
                 + list(bs.values())):
        trules.placements(spec, mesh)
    return ps, cs


def mesh_paths_against_reference(name, batches, toks, enc=None, max_seq=None):
    """The one-process paths the family-on-a-mesh tests hold the ranks to,
    on bridged weights beside ``jax.jit`` of the reference's: per-leaf
    momentum-SGD steps over ``batches`` (torch tensors of the model's
    ``input_specs`` keys), ``forward`` over the first of them (labels
    left out) and the serve step over the (B, T) ``toks`` from empty
    caches (whisper's ``enc`` set to ``enc`` in both). Returns {"losses",
    "logits", "serve"}, each (port, reference)."""
    jm, tm, jp, tp = bridged(name)
    jb = [{k: jnp.asarray(v.numpy()) for k, v in b.items()} for b in batches]
    jopt = jsgd.sgd(0.1, momentum=0.9)
    jsync = JSyncConfig(mode="mpi_sgd", fused_update=False, flat_exchange=False)
    jstate = jtrain.make_train_state(jm, jopt, jsync, jax.random.key(0))
    jstate["params"] = jax.tree.map(jnp.asarray, jp)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt, jsync, None))
    opt = tsgd.sgd(0.1, 0.9)
    sync = SyncConfig(mode="mpi_sgd", fused_update=False, flat_exchange=False)
    state = ttrain.make_train_state(tm, opt, sync, device="cpu")
    state["params"] = tp
    step = ttrain.make_train_step(tm, opt, sync, None, device="cpu")
    jl, tl = [], []
    for b, j in zip(batches, jb):
        jstate, jmet = jstep(jstate, j)
        state, met = step(state, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(met["loss"]))
    fwd = lambda b: {k: v for k, v in b.items() if k != "labels"}
    want = f32(jax.jit(jm.forward)(jp, fwd(jb[0])))
    with torch.no_grad():
        got = f32(tm.forward(tp, fwd(batches[0])))
    B, T = toks.shape
    max_seq = max_seq or T
    jc, tc = jm.init_cache(B, max_seq), tm.init_cache(B, max_seq, "cpu")
    if enc is not None:
        jc = dict(jc, enc=jnp.asarray(enc.numpy()))
        tc["enc"].copy_(enc)
    jserve = jax.jit(jm.serve_step)
    js, ts = [], []
    for t in range(T):
        a, jc = jserve(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        b, tc = tm.serve_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        js.append(f32(a))
        ts.append(f32(b))
    return {"losses": (tl, jl), "logits": (got, want), "serve": (ts, js)}


def param_numel(tree) -> int:
    return sum(a.numel() for a in tree_leaves(tree))


def bf16_drift(name, layers, B, T, seed=0):
    """bf16 decode against bf16 ``forward`` over the same T bigram tokens,
    the reference (``jax.jit``) and the port on the CPU from the same
    weights (the port's seed-``seed`` init at full width, cut to
    ``layers``): max |Δlogit| over max |logit| for each, and the port's
    forward against the reference's."""
    from repro_torch.bridge import params_to_numpy

    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    jcfg = dataclasses.replace(jget_config(name), num_layers=layers)
    tm, jm = build_model(cfg), jbuild_model(jcfg)
    tp = tm.init(device="cpu", seed=seed)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    toks = TokenPipeline(DataConfig(seed=seed, vocab_size=256, seq_len=T,
                                    batch_size=B)).batch_at(0, 0)["tokens"]
    V = cfg.vocab_size
    jf = f32(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks.numpy())}))[..., :V]
    with torch.no_grad():
        tf = f32(tm.forward(tp, {"tokens": toks}))[..., :V]
        jl, tl, _, _ = teacher_forced(jm, tm, jp, tp, toks.numpy(), T)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    return {"reference": rel(np.concatenate(jl, 1)[..., :V], jf),
            "port": rel(np.concatenate(tl, 1)[..., :V], tf), "forwards": rel(tf, jf)}


if __name__ == "__main__":
    # PYTHONPATH=src python tests/_torch_families.py mamba2-130m 24 8 128
    import sys

    torch.set_num_threads(8)
    name, layers, B, T = sys.argv[1], *map(int, sys.argv[2:5])
    print(name, f"{layers} layers, B {B} x {T} tokens, bf16 decode vs forward "
          f"(max |Δlogit| / max |logit|):", bf16_drift(name, layers, B, T))
