"""The port's KVStore-MPI (``repro_torch.core.kvstore``): the API semantics
of ``tests/test_kvstore.py``, and the port against the reference's store
(``repro.core.kvstore``) on the same pushes — sync and sync_mpi barriers
with group pushes over 1- and 2-axis communicators, the barrier timeout
and late pushes, the async optimize rule (flat sgd / adamw / adagrad)
with staleness scaling, and the elastic rule over the f32 / bf16 / int8
PS wire with its byte accounting — plus the paths the faults slice
ported: a list push through the grouped-vector reduction, the per-leaf
int8 codec, and an attached membership.

Tolerances: f32 values exactly equal, except where a group pushes over
the int8 wire (see ``test_group_push_int8_wire_band``) and the async
optimize rules (rtol 1e-6, about 8 f32 ulps: the port's fused optimizer
kernels round each operation where the reference's compiled code
contracts some into fused multiply-adds — SGD lands 1 ulp off on ~5 % of
the elements); byte counters equal."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import comm as JC, flatbuf as jflatbuf  # noqa: E402
from repro.core.kvstore import KVStore as JKV  # noqa: E402
from repro.core.scheduler import StalenessTracker as JTracker  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import comm as TC, flatbuf as tflatbuf  # noqa: E402
from repro_torch.core.kvstore import KVStore, local_reduce  # noqa: E402
from repro_torch.core.scheduler import StalenessTracker  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")
torch.set_num_threads(2)

SHAPES = {"a": (3, 50), "b": {"c": (129,), "d": (7, 11, 2)}}


def _np_tree(seed, lead=(), scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(lead + s)).astype(np.float32),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return params_from_numpy(tree)


def _assert_equal(jtree, ttree, rtol=0.0):
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtree))
    got = jax.tree.leaves(params_to_numpy(ttree))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def _both(kv_type, **kw):
    return JKV.create(kv_type, **kw), KVStore.create(kv_type, **kw)


# -- the API semantics of tests/test_kvstore.py ----------------------------------

def test_init_and_pull_broadcast():
    kv = KVStore.create("dist_sync", num_workers=3)
    kv.init("w", torch.arange(4.0))
    vals = kv.pull("w", num_dst=2)
    assert len(vals) == 2 and torch.equal(vals[0], torch.arange(4.0))


def test_double_init_and_unknown_keys_raise():
    kv = KVStore.create("local")
    kv.init("w", torch.zeros(2))
    with pytest.raises(KeyError):
        kv.init("w", torch.zeros(2))
    with pytest.raises(KeyError, match="known keys: 'w'"):
        kv.push("nope", torch.zeros(2))
    with pytest.raises(KeyError):
        kv.pull("nope")


def test_sync_barrier_blocks_pull_until_all_push():
    kv = KVStore.create("dist_sync", num_workers=2)
    kv.init("g", torch.zeros(3))
    kv.push("g", torch.ones(3))
    with pytest.raises(RuntimeError, match="barrier incomplete"):
        kv.pull("g")
    kv.push("g", 2 * torch.ones(3))
    assert torch.equal(kv.pull("g")[0], 3 * torch.ones(3))


def test_sync_mpi_expects_client_count_not_worker_count():
    kv = KVStore.create("sync_mpi", num_workers=6, num_clients=2)
    assert kv.expected_pushers == 2
    kv.init("g", torch.zeros(1))
    kv.push("g", torch.ones(1))
    kv.push("g", torch.ones(1))
    assert torch.equal(kv.pull("g")[0], torch.tensor([2.0]))


def test_async_applies_immediately_and_pushpull():
    kv = KVStore.create("dist_async", num_workers=4)
    kv.init("g", torch.zeros(2))
    kv.push("g", torch.ones(2))
    assert torch.equal(kv.pull("g")[0], torch.ones(2))
    out = kv.pushpull("g", [2 * torch.ones(2)], num_dst=3)   # one-entry list
    assert len(out) == 3 and torch.equal(out[0], 2 * torch.ones(2))


def test_server_optimizer_rule():
    kv = KVStore.create("dist_async", num_workers=1)
    kv.init("w", torch.ones(3))
    kv.set_optimizer(tsgd.sgd(0.5), rescale=0.1)
    kv.push("w", torch.ones(3))
    torch.testing.assert_close(kv.pull("w")[0], 0.95 * torch.ones(3))


def test_elastic_server_rule():
    kv = KVStore.create("dist_async", num_workers=1)
    kv.init("c", torch.zeros(2))
    kv.set_elastic(0.5)
    kv.push("c", torch.ones(2) * 4.0)
    assert torch.equal(kv.pull("c")[0], 2.0 * torch.ones(2))


def test_invalid_type_and_removed_knob_rejected():
    with pytest.raises(ValueError):
        KVStore.create("bogus")
    with pytest.raises(ValueError, match="wire_dtype='int8'"):
        KVStore.create("dist_sync", compress_push=True)
    with pytest.raises(ValueError, match="wire_dtype"):
        KVStore.create("dist_sync", wire_dtype="fp8")


def test_bytes_per_server_and_placement_equal_reference():
    jkv, tkv = _both("dist_sync", num_workers=12, num_servers=3)
    jkv.init("w", jnp.zeros((1000,), jnp.float32))
    tkv.init("w", torch.zeros(1000))
    assert tkv.bytes_per_server_per_sync("w") == \
        jkv.bytes_per_server_per_sync("w") == 4000 * 12 // 3
    for key in ("w", "grads", 7, ("layer", 3), "centers"):
        assert tkv.server_of(key) == jkv.server_of(key)
    assert tkv.keys() == ["w"]


def test_group_errors():
    kv = KVStore.create("sync_mpi", num_workers=4, num_clients=2)
    kv.init("g", torch.zeros(2))
    with pytest.raises(TypeError, match="Communicator"):
        kv.register_group(0, "worker")
    with pytest.raises(KeyError, match="register_group"):
        kv.push("g", torch.zeros((1, 2)), group=7)
    kv.register_group(0, TC.Communicator.world(("worker",), (2,)))
    with pytest.raises(ValueError, match="stacked members"):
        kv.group_reduce(0, {"w": torch.zeros((3, 6))})


# -- port == reference on the same pushes --------------------------------------

GROUPS = {
    "1axis-multi_ring": (("worker",), (2,), dict(method="multi_ring", num_rings=2)),
    "1axis-ring-bf16": (("worker",), (2,), dict(method="ring", wire_dtype="bf16")),
    "1axis-tree": (("worker",), (4,), dict(method="tree")),
    "2axis-ring": (("pod", "data"), (2, 2), dict(method="ring", num_rings=2)),
}


@pytest.mark.parametrize("kv_type", ["sync_mpi", "dist_sync"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_sync_group_push_barrier_matches_reference(kv_type, group):
    """Each of two clients pushes its stacked member grads with group=c:
    the group collective runs in the store, the barrier sums the client
    sums as one packed buffer in arrival order, the assign rule stores
    the total."""
    axes, sizes, pol = GROUPS[group]
    members = int(np.prod(sizes))
    jkv, tkv = _both(kv_type, num_workers=2 if kv_type == "dist_sync" else 4,
                     num_clients=2)
    jg = JC.Communicator.world(axes, sizes, policy=JC.CollectivePolicy(**pol))
    tg = TC.Communicator.world(axes, sizes, policy=TC.CollectivePolicy(**pol))
    zeros = jax.tree.map(np.zeros_like, _np_tree(0))
    jkv.init("grads", _j(zeros))
    tkv.init("grads", _t(zeros))
    for c in range(2):
        jkv.register_group(c, jg)
        tkv.register_group(c, tg)
    for c in range(2):
        stacked = _np_tree(10 + c, lead=(members,))
        jkv.push("grads", _j(stacked), group=c)
        tkv.push("grads", _t(stacked), group=c)
    _assert_equal(jkv.pull("grads")[0], tkv.pull("grads")[0])
    assert tkv.group_sync_count == jkv.group_sync_count == {0: 1, 1: 1}
    assert tkv.last_barrier_count == jkv.last_barrier_count == 2
    assert tkv.pushed_bytes == jkv.pushed_bytes
    assert tkv.pushed_bytes_uncompressed == jkv.pushed_bytes_uncompressed


def test_group_push_int8_wire_band():
    """Over the int8 wire the group collective runs the per-hop codec,
    which computes its scale as ``absmax / 127`` — the reference's eager
    form. The reference's store runs the collective under ``jit``, where
    XLA multiplies by f32(1/127) instead (one ulp off on ~4 % of the
    scales), so a code next to a rounding boundary can differ: every
    element within two quantization steps of the bucket, and at most 1 %
    of them off the f32 tolerance."""
    pol = dict(method="multi_ring", num_rings=2, wire_dtype="int8")
    jg = JC.Communicator.world(("worker",), (2,), policy=JC.CollectivePolicy(**pol))
    tg = TC.Communicator.world(("worker",), (2,), policy=TC.CollectivePolicy(**pol))
    stacked = _np_tree(3, lead=(2,))
    jkv, tkv = _both("async_mpi", num_workers=2, num_clients=1)
    jkv.register_group(0, jg)
    tkv.register_group(0, tg)
    want = jax.tree.leaves(jax.tree.map(
        np.asarray, jkv.group_reduce(0, _j(stacked))))
    got = jax.tree.leaves(params_to_numpy(tkv.group_reduce(0, _t(stacked))))
    off = total = 0
    for w, g in zip(want, got):
        step = 2 * np.abs(w).max() / 127
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * step)
        off += int((np.abs(g - w) > 1e-5 + 1e-3 * np.abs(w)).sum())
        total += w.size
    assert off <= 0.01 * total, (off, total)


def test_barrier_timeout_release_and_late_push_match_reference():
    """Three clients, timeout 1.0 s: client 0 at t = 0, client 2 at
    t = 1.5 (late: discarded), then pull(now=1.0) releases the barrier
    with client 0 and 1's pushes; the optimize rule rescales the short
    sum by 3/2."""
    out = {}
    for name, kv, wrap, opt in (
            ("jax", JKV.create("sync_mpi", num_workers=3, num_clients=3,
                               barrier_timeout=1.0), _j, jsgd.sgd(0.1)),
            ("port", KVStore.create("sync_mpi", num_workers=3, num_clients=3,
                                    barrier_timeout=1.0), _t, tsgd.sgd(0.1))):
        kv.init("w", wrap(_np_tree(0)))
        kv.set_optimizer(opt, rescale=0.5)
        kv.push("w", wrap(_np_tree(1)), at=0.0)
        kv.push("w", wrap(_np_tree(2)), at=1.5)
        kv.push("w", wrap(_np_tree(3)), at=0.4)
        with pytest.raises(RuntimeError):
            kv.pull("w", now=0.9)
        value = kv.pull("w", now=1.0)[0]
        out[name] = (value, kv.degraded_syncs, kv.late_pushes,
                     kv.last_barrier_count)
    _assert_equal(out["jax"][0], out["port"][0])
    assert out["port"][1:] == out["jax"][1:] == (1, 1, 2)


FLAT_OPTS = {
    "sgd": (lambda m, s: m.flat_sgd(0.1, 0.9, s), 1e-6),
    "adamw": (lambda m, s: m.flat_adamw(3e-3, s), 1e-6),
    "adagrad": (lambda m, s: m.flat_adagrad(1e-2, s), 1e-6),
}


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("opt_name", sorted(FLAT_OPTS))
def test_async_optimize_rule_with_staleness_matches_reference(opt_name, scale):
    """Two units push grads to one async store whose rule is a fused flat
    optimizer; unit 1 pulls once and pushes twice, so its pushes land 1
    and 2 versions stale. With ``scale`` the rule damps them by
    1/(1+s) on the packed buffer."""
    make, rtol = FLAT_OPTS[opt_name]
    p0 = _np_tree(0)
    out = {}
    for name, kv, wrap, mod, flat, tracker in (
            ("jax", JKV.create("async_mpi", num_workers=4, num_clients=2),
             _j, jsgd, jflatbuf, JTracker()),
            ("port", KVStore.create("async_mpi", num_workers=4, num_clients=2),
             _t, tsgd, tflatbuf, StalenessTracker())):
        kv.init("params", wrap(p0))
        kv.set_optimizer(make(mod, flat.spec_for(wrap(p0))), rescale=1.0)
        kv.attach_staleness(tracker, scale=scale)
        for u in (0, 1):
            tracker.on_pull(u)
        for u, seed in ((0, 1), (1, 2), (1, 3), (0, 4)):
            kv.push("params", wrap(_np_tree(seed, scale=0.1)), unit=u)
            if u == 0:
                kv.pull("params", unit=u)
        out[name] = (kv.value("params"), list(tracker.history))
    _assert_equal(out["jax"][0], out["port"][0], rtol=rtol)
    assert out["port"][1] == out["jax"][1] == [0, 1, 2, 2]


@pytest.mark.parametrize("wire,flat_exchange", [
    (None, True), ("bf16", True), ("int8", True), (None, False),
    ("bf16", False), ("int8", False)])
def test_elastic_rule_over_the_ps_wire_matches_reference(wire, flat_exchange):
    """Two pushes into the elastic rule (eq. 2) over the PS wire: the
    packed int8 wire (one quantize + dequantize of the packed push), the
    bf16 cast, or f32; the fused server kernel or the per-leaf rule. The
    centers and both byte counters equal the reference's."""
    c0 = _np_tree(5)
    jkv, tkv = _both("async_mpi", num_workers=4, num_clients=2,
                     wire_dtype=wire, flat_exchange=flat_exchange)
    for kv, wrap in ((jkv, _j), (tkv, _t)):
        kv.init("centers", wrap(c0))
        kv.set_elastic(0.5 / 3)
        for seed in (6, 7):
            kv.push("centers", wrap(_np_tree(seed)))
    _assert_equal(jkv.value("centers"), tkv.value("centers"))
    assert tkv.pushed_bytes == jkv.pushed_bytes
    assert tkv.pushed_bytes_uncompressed == jkv.pushed_bytes_uncompressed
    payload = tflatbuf.spec_for(_t(c0)).payload
    per_push = {None: 4 * payload, "bf16": 2 * payload,
                "int8": payload + -(-payload // 128) * 4}[wire]
    if wire == "int8" and not flat_exchange:      # the per-leaf QBLOCK codec
        per_push = sum(l.size + -(-l.size // 1024) * 4
                       for l in jax.tree.leaves(params_to_numpy(_t(c0))))
    assert tkv.pushed_bytes == 2 * per_push
    assert tkv.pushed_bytes_uncompressed == 2 * 4 * payload


def test_elastic_rule_writes_no_input():
    """The rule stores new tensors: the tree a client pushed and the
    center it read before the push keep their values."""
    c0, w = _t(_np_tree(8)), _t(_np_tree(9))
    c0_copy = jax.tree.map(np.copy, params_to_numpy(c0))
    w_copy = jax.tree.map(np.copy, params_to_numpy(w))
    kv = KVStore.create("async_mpi", num_workers=2, num_clients=1,
                        wire_dtype="int8")
    kv.init("centers", c0)
    kv.set_elastic(0.5)
    old = kv.value("centers")
    kv.push("centers", w)
    assert kv.value("centers") is not old
    for tree, copy in ((old, c0_copy), (w, w_copy)):
        for a, b in zip(jax.tree.leaves(params_to_numpy(tree)),
                        jax.tree.leaves(copy)):
            np.testing.assert_array_equal(a, b)


def test_slice4_paths_raise():
    """The paths that raised until the faults slice ported them now run
    as the reference's do: ``attach_membership`` degrades the barrier, a
    list push of several values is reduced by ``local_reduce``, and an
    int8 push outside the flat elastic rule takes the per-leaf codec."""
    from repro.core.kvstore import local_reduce as jlocal
    from repro.core.membership import Membership as JMembership
    from repro_torch.core.membership import Membership

    jkv, tkv = _both("dist_sync", num_workers=2)
    for kv, M in ((jkv, JMembership), (tkv, Membership)):
        m = M(2)
        kv.attach_membership(m)
        m.leave(1)
        assert kv.expected_pushers == 1
    for kv, wrap in ((jkv, jnp.asarray), (tkv, torch.tensor)):
        kv.init("g", wrap(np.zeros(3, np.float32)))
        kv.push("g", [wrap(np.ones(3, np.float32)), wrap(np.full(3, 2.0, np.float32))])
    np.testing.assert_array_equal(tkv.value("g").numpy(), np.asarray(jkv.value("g")))
    assert torch.equal(tkv.value("g"), torch.full((3,), 3.0))
    assert torch.equal(local_reduce([torch.ones(3), torch.ones(3)]), torch.full((3,), 2.0))
    np.testing.assert_array_equal(
        local_reduce([torch.ones(3), torch.ones(3)]).numpy(),
        np.asarray(jlocal([jnp.ones(3), jnp.ones(3)])))
    assert torch.equal(local_reduce([torch.ones(3)]), torch.ones(3))
    # int8 outside the flat elastic rule: the per-leaf QBLOCK codec
    for kv_type, elastic in (("dist_sync", False), ("dist_async", True)):
        out = []
        for KV, wrap in ((JKV, jnp.asarray), (KVStore, torch.tensor)):
            kv = KV.create(kv_type, num_workers=1, wire_dtype="int8",
                           flat_exchange=False)
            kv.init("c", wrap(np.zeros(3, np.float32)))
            if elastic:
                kv.set_elastic(0.5)
            kv.push("c", wrap(np.asarray([1.0, -0.5, 0.25], np.float32)))
            out.append((np.asarray(kv.value("c")), kv.pushed_bytes))
        np.testing.assert_array_equal(out[1][0], out[0][0])
        assert out[1][1] == out[0][1] == 3 + 4
