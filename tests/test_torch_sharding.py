"""The port's sharding rules and spec functions held against the
reference's, entry for entry, with no processes: ``sharding/rules.py``
(``logical_to_pspec``, ``param_specs`` with and without FSDP,
``batch_pspec``), ``core/hierarchy.py`` (``clientize_specs``,
``grad_sync_axes``, ``pod_mean``), ``launch/train.py`` (``state_specs``,
``batch_specs``, ``clientize_batch_specs``) and ``launch/serve.py``
(``cache_specs``, ``token_specs``).

The trees are shape-only on both sides — ``meta`` tensors against
``jax.eval_shape`` — for all ten ``ARCH_IDS`` at reduced and full width,
on ``.shape``-only meshes of the production (16, 16), multi-pod
(2, 16, 16), MoE (16, 8, 2) and host (2, 2) layouts. Then the port's own
additions: ``placements`` (a ``P`` as DTensor placements; a joint entry
out of mesh order raises) and ``make_sync_engine(mesh)`` (the per-leaf
engine, as the reference's). Tolerances: every spec exact; ``pod_mean``
within f32 rounding (rtol 1e-6)."""
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import hierarchy as jhier, sync_engine as jengine  # noqa: E402
from repro.launch import serve as jserve, train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import hierarchy as thier  # noqa: E402
from repro_torch.core.sync_engine import FlatEngine, SyncEngine, make_sync_engine  # noqa: E402
from repro_torch.launch import serve as tserve, train as ttrain  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from repro_torch.sharding.rules import P, is_spec, placements  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")

MESHES = {
    "production": {"data": 16, "model": 16},
    "multi_pod": {"pod": 2, "data": 16, "model": 16},
    "moe": {"data": 16, "expert": 8, "tp": 2},
    "host": {"data": 2, "model": 2},
}


def _mesh(name):
    return SimpleNamespace(shape=dict(MESHES[name]))


def _jflat(specs) -> dict:
    """A reference spec tree as {key path: spec}."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    key = lambda path: "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                for k in path)
    return {key(path): s for path, s in pairs}


def _tflat(specs) -> dict:
    """A port spec tree as {key path: spec}."""
    pairs, _ = tree_flatten_with_path(specs, is_leaf=is_spec)
    return {"/".join(str(k) for _, k in path): s for path, s in pairs}


def _assert_specs_equal(tspecs, jspecs):
    t, j = _tflat(tspecs), _jflat(jspecs)
    assert list(t) == list(j)
    for k in j:
        assert isinstance(t[k], P), k
        assert tuple(t[k]) == tuple(j[k]) and j[k] == t[k], (k, t[k], j[k])


def _models(arch, width):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    if width == "reduced":
        j, t = jbase.reduced(j), tbase.reduced(t)
    return jbuild(j), tbuild(t)


# -- the reference's own cases ------------------------------------------------

def test_logical_to_pspec_and_batch_pspec_reference_cases():
    """``tests/test_substrate.py``'s divisibility and fallback cases."""
    prod, pod = _mesh("production"), _mesh("multi_pod")
    for logical, shape in [(("vocab", None), (151936, 2048)), (("heads",), (24,)),
                           ((None, "ff"), (100, 1408)), (("expert", None, "ff"), (8, 4, 32))]:
        for m in (prod, pod, _mesh("moe"), _mesh("host")):
            assert tuple(trules.logical_to_pspec(logical, shape, m)) == \
                tuple(jrules.logical_to_pspec(logical, shape, m))
    assert trules.logical_to_pspec(("vocab", None), (151936, 2048), prod) == P("model")
    assert trules.logical_to_pspec(("heads",), (24,), prod) == P()
    for batch in (256, 16, 1, 2, 32):
        for extra in (0, 1, 2):
            for m in (prod, pod, _mesh("moe"), _mesh("host")):
                want = jrules.batch_pspec(m, batch, extra_dims=extra)
                got = trules.batch_pspec(m, batch, extra_dims=extra)
                assert tuple(got) == tuple(want) and want == got
    assert trules.batch_pspec(pod, 256) == P(("pod", "data"), None)
    assert trules.batch_pspec(pod, 16) == P("data", None)
    assert trules.batch_pspec(pod, 1) == P(None, None)
    for name in MESHES:
        assert trules.data_axis_names(_mesh(name)) == jrules.data_axis_names(_mesh(name))


def test_clientize_specs_and_grad_sync_axes_reference_cases():
    """``tests/test_train.py``'s cases, and a deeper tree."""
    specs = {"w": P(None, "model")}
    assert thier.clientize_specs(specs, 2)["w"] == P("pod", None, "model")
    assert thier.clientize_specs(specs, 1) is specs
    tree = {"a": {"b": P(("pod", "data")), "c": P()}, "d": P("model", None)}
    jtree = {"a": {"b": JP(("pod", "data")), "c": JP()}, "d": JP("model", None)}
    _assert_specs_equal(thier.clientize_specs(tree, 3), jhier.clientize_specs(jtree, 3))
    for name in MESHES:
        for C in (1, 2):
            assert thier.grad_sync_axes(_mesh(name), C) == jhier.grad_sync_axes(_mesh(name), C)
    assert thier.grad_sync_axes(_mesh("multi_pod"), 1) == ("pod", "data")
    assert thier.grad_sync_axes(_mesh("multi_pod"), 2) == ("data",)


def test_pod_mean_equals_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((2, 5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 7)).astype(np.float32)}}
    want = jhier.pod_mean(jax.tree.map(jnp.asarray, tree))
    got = thier.pod_mean({"w": torch.from_numpy(tree["w"]),
                          "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# -- param_specs over every architecture -------------------------------------

@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_param_specs_equal_reference(arch, width):
    """Every leaf's spec, with and without FSDP, on the four layouts."""
    jm, tm = _models(arch, width)
    jparams = jax.eval_shape(jm.init, jax.random.key(0))
    tparams = tm.init(device="meta")
    for name in MESHES:
        for fsdp in (False, True):
            _assert_specs_equal(trules.param_specs(tparams, _mesh(name), fsdp=fsdp),
                                jrules.param_specs(jparams, _mesh(name), fsdp=fsdp))


# -- train-state and batch specs ---------------------------------------------

OPTS = {"sgd": (lambda: tsgd.sgd(0.1, 0.9), lambda: jsgd.sgd(0.1, momentum=0.9)),
        "sgd0": (lambda: tsgd.sgd(0.1), lambda: jsgd.sgd(0.1)),
        "adamw": (lambda: tsgd.adamw(1e-3), lambda: jsgd.adamw(1e-3)),
        "adagrad": (lambda: tsgd.adagrad(1e-2), lambda: jsgd.adagrad(1e-2))}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("clients", [1, 2])
def test_state_specs_equal_reference(clients, opt, fsdp):
    """``state_specs`` of the per-leaf state (the mesh path's layout): the
    params' rules, the client dim on 'pod', the optimizer state sharing the
    param specs only where its tree mirrors the params'."""
    jm, tm = _models("qwen2-0.5b", "reduced")
    mode = "mpi_esgd" if clients > 1 else "mpi_sgd"
    jsync = jhier.SyncConfig(mode=mode, num_clients=clients, fused_update=False,
                             fsdp=fsdp)
    tsync = thier.SyncConfig(mode=mode, num_clients=clients, fused_update=False,
                             fsdp=fsdp)
    topt, jopt = OPTS[opt]
    jstate = jtrain.make_train_state(jm, jopt(), jsync, abstract=True)
    tstate = ttrain.make_train_state(tm, topt(), tsync, device="meta")
    meshes = ["multi_pod"] if clients > 1 else list(MESHES)
    for name in meshes:
        _assert_specs_equal(ttrain.state_specs(tstate, _mesh(name), tsync),
                            jtrain.state_specs(jstate, _mesh(name), jsync))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "paligemma-3b", "whisper-base"])
def test_batch_specs_equal_reference(arch):
    jm, tm = _models(arch, "reduced")
    shapes = [("train_4k", 4096, 256), ("small", 64, 8), ("odd", 32, 3)]
    for name, seq, batch in shapes:
        jshape = jbase.InputShape(name, seq, batch, "train")
        tshape = tbase.InputShape(name, seq, batch, "train")
        for C in (1, 2):
            if batch % C:
                continue
            jsync = jhier.SyncConfig(mode="mpi_esgd" if C > 1 else "mpi_sgd",
                                     num_clients=C)
            tsync = thier.SyncConfig(mode="mpi_esgd" if C > 1 else "mpi_sgd",
                                     num_clients=C)
            for mname in (["multi_pod"] if C > 1 else list(MESHES)):
                m = _mesh(mname)
                _assert_specs_equal(ttrain.batch_specs(tm, tshape, m, tsync),
                                    jtrain.batch_specs(jm, jshape, m, jsync))
            jc = jtrain.clientize_batch_specs(jm.input_specs(jshape), C)
            tc = ttrain.clientize_batch_specs(tm.input_specs(tshape), C)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in tc.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in jc.items()}


# -- serving specs --------------------------------------------------------------

@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_cache_specs_equal_reference(arch):
    """Each family's decode-state tree (reduced, and the full-width one at
    a decode batch), on the four layouts."""
    for width, batch, seq in (("reduced", 4, 64), ("full", 128, 256)):
        jm, tm = _models(arch, width)
        jcache = jax.eval_shape(lambda: jm.init_cache(batch, seq))
        tcache = tm.init_cache(batch, seq, device="meta")
        for name in MESHES:
            _assert_specs_equal(tserve.cache_specs(tcache, _mesh(name)),
                                jserve.cache_specs(jcache, _mesh(name)))


def test_cache_and_token_specs_reference_cases():
    """``tests/test_launch.py``'s shardable-dims case, and token specs."""
    m = _mesh("production")
    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    cache = {"k": meta(24, 128, 4096, 8, 64), "v": meta(24, 128, 4096, 8, 64),
             "index": meta(24, dt=torch.int32),
             "h": meta(24, 1, 24, 64, 128, dt=torch.float32)}
    jcache = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
              for k, v in cache.items()}
    specs = tserve.cache_specs(cache, m)
    _assert_specs_equal(specs, jserve.cache_specs(jcache, m))
    assert specs["k"][1] == "data" and specs["index"] == P()
    assert specs["h"][3] == "model"
    for shape in ((128, 1), (3, 1), (16, 7)):
        for name in MESHES:
            want = jserve.token_specs(shape, _mesh(name))
            got = tserve.token_specs(shape, _mesh(name))
            assert tuple(got) == tuple(want) and want == got


# -- the port's own additions ---------------------------------------------------

def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    m = SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2})
    assert placements(P(("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements(P(), m) == [Replicate()] * 3
    assert placements(P(None, "data"), m) == [Replicate(), Shard(1), Replicate()]
    assert placements(P("pod", "data"), m) == [Shard(0), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="not in mesh order"):
        placements(P(("data", "pod")), m)
    with pytest.raises(ValueError, match="lacks"):
        placements(P("expert"), m)
    with pytest.raises(ValueError, match="twice"):
        placements(P("data", "data"), m)


def test_hints_leave_plain_tensors_unchanged():
    """On a plain tensor the model code's hints are no-ops (no mesh)."""
    x = torch.randn(4, 8, 16)
    assert trules.shard_batch_dim(x) is x
    assert trules.maybe_seq_shard(x, True) is x
    assert trules.unshard_dim(x, -1) is x
    table, toks = torch.randn(16, 8), torch.randint(0, 16, (2, 3))
    assert torch.equal(trules.embedding_lookup(table, toks),
                       torch.nn.functional.embedding(toks.long(), table))
    out = trules.on_local_heads(lambda a, b: a + b, x, x)
    assert torch.equal(out, x + x)


@pytest.mark.parametrize("mode", ["mpi_sgd", "mpi_esgd"])
def test_make_sync_engine_with_mesh_is_per_leaf(mode):
    """With a mesh the engine is the per-leaf one, as the reference's:
    no flat update, no flat exchange, the trivial gradient group, and a
    per-leaf optimizer state."""
    tm = tbuild(tbase.reduced(tbase.get_config("qwen2-0.5b")))
    jm = jbuild(jbase.reduced(jbase.get_config("qwen2-0.5b")))
    mesh = _mesh("host")
    tsync = thier.SyncConfig(mode=mode)
    jsync = jhier.SyncConfig(mode=mode)
    eng = make_sync_engine(tsgd.sgd(0.1, 0.9), tsync, mesh,
                           spec=ttrain.grad_spec(tm))
    jeng = jengine.make_sync_engine(jsgd.sgd(0.1, momentum=0.9), jsync, mesh,
                                    spec=jtrain.grad_spec(jm))
    assert type(eng) is SyncEngine and not isinstance(eng, FlatEngine)
    assert type(jeng) is jengine.SyncEngine
    assert (eng.fused, eng.flat_exchange) == (jeng.fused, jeng.flat_exchange) == (False, False)
    assert eng.comm.resolve_size() == jeng.comm.resolve_size() == 1
    params = tm.init(device="cpu")
    opt = eng.init_opt(params)
    assert [tuple(v.shape) for v in tree_leaves(opt)] == \
        [tuple(v.shape) for v in tree_leaves(params)]
    eng.check_opt_layout(opt)
    # without a mesh the same config takes the flat engine
    assert isinstance(make_sync_engine(tsgd.sgd(0.1, 0.9), tsync,
                                       spec=ttrain.grad_spec(tm)), FlatEngine)


def test_config_fields_equal_reference():
    """The port's ModelConfig has every field of the reference's, with the
    reference's defaults (``remat`` / ``unroll_layers`` /
    ``seq_shard_activations`` included)."""
    tf = {f.name: f.default for f in dataclasses.fields(tbase.ModelConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(jbase.ModelConfig)}
    assert tf == jf
