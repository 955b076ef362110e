"""mpi-ESGD through the port's train step: the C = 2 multi-client step
against the reference's, the port's 2-axis shard driver against its own
multi-client step, and the guards of the paths later slices port.

Tolerances: per-step losses rtol 1e-4; final params and center rtol 1e-3
/ atol 1e-5 (AdamW at eps 1e-5, as tests/test_torch_train.py holds it).
"""
import importlib

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSync  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core.comm import CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import (  # noqa: E402
    SyncConfig,
    clientize,
    declientize,
    should_elastic_sync,
)
from repro_torch.core.sync_engine import SyncEngine, make_sync_engine  # noqa: E402
from repro_torch.launch import shard_driver as TSD, train as ttrain  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")
torch.set_num_threads(2)

HYPER = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=3e-3, eps=1e-5)}


@pytest.fixture(scope="module")
def tmodel():
    return build_model(reduced(get_config("qwen2-0.5b")))


def _batch(seed, B=8, S=32):
    toks = np.random.default_rng(seed).integers(0, 1024, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _clients(batch, C):
    return {k: v.reshape((C, v.shape[0] // C) + v.shape[1:]) for k, v in batch.items()}


def _close(ref, port, rtol=1e-3, atol=1e-5):
    want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), ref))
    got = [np.asarray(a, np.float32) for a in jax.tree.leaves(params_to_numpy(port))]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("flat_exchange", [True, False])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_multiclient_esgd_step_matches_reference(tmodel, opt_name, flat_exchange):
    """C = 2, interval 2, 4 steps: the per-client fused update, then the
    exchange on steps 0 and 2 (flat: one fused kernel; per-leaf: tree
    maps), loss averaged over clients."""
    C = 2
    kw = dict(mode="mpi_esgd", num_clients=C, esgd_interval=2, esgd_alpha=0.5,
              flat_exchange=flat_exchange)
    jmodel = jbuild_model(jreduced(jget_config("qwen2-0.5b")))
    jopt = jsgd.get_optimizer(opt_name, **HYPER[opt_name])
    topt = tsgd.get_optimizer(opt_name, **HYPER[opt_name])
    jst = jtrain.make_train_state(jmodel, jopt, JSync(**kw), jax.random.key(1))
    jstep = jax.jit(jtrain.make_train_step(jmodel, jopt, JSync(**kw), None))
    tst = ttrain.make_train_state(tmodel, topt, SyncConfig(**kw), device="cpu")
    assert sorted(tst) == sorted(jst)
    for key in jst:
        assert [tuple(a.shape) for a in tree_leaves(tst[key])] == \
            [tuple(a.shape) for a in jax.tree.leaves(jst[key])], key
    for key in ("params", "center"):
        tst[key] = params_from_numpy(jax.tree.map(np.asarray, jst[key]))
    tstep = ttrain.make_train_step(tmodel, topt, SyncConfig(**kw), device="cpu")
    for i in range(4):
        cb = _clients(_batch(i), C)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in cb.items()})
        tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in cb.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4), i
    assert int(tst["step"]) == 4
    _close(jst["params"], tst["params"])
    _close(jst["center"], tst["center"])


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_driver_2axis_esgd_matches_multiclient_step(tmodel, opt_name):
    """The port's (2, 2) shard driver — client == pod, gradient leg over
    'data', state 1/D per device, exchange across 'pod' at α/P — equals
    its own stacked C = 2 step, crossing two INTERVAL boundaries."""
    P, D = 2, 2
    opt = tsgd.get_optimizer(opt_name, **HYPER[opt_name])
    sync = SyncConfig(mode="mpi_esgd", num_clients=P, esgd_interval=2,
                      esgd_alpha=0.5, policy=CollectivePolicy(method="ring",
                                                              num_rings=2))
    ref = ttrain.make_train_state(tmodel, opt, sync, seed=1, device="cpu")
    ref_step = ttrain.make_train_step(tmodel, opt, sync, device="cpu")
    drv = TSD.make_driver_state(tmodel, opt, sync, (P, D), seed=1, device="cpu")
    drv_step = TSD.make_emulated_step(tmodel, opt, sync, (P, D))
    for i in range(4):
        b = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        ref, mr = ref_step(ref, TSD.shard_batch(b, P))
        drv, md = drv_step(drv, TSD.shard_batch(b, (P, D)))
        assert float(md["loss"]) == pytest.approx(float(mr["loss"]), rel=1e-4), i
    tol = dict(rtol=2e-4, atol=2e-5) if opt_name == "sgd" else dict(rtol=5e-3, atol=5e-4)
    for c in range(P):   # device d of pod c holds client c's replica
        for a, b in zip(tree_leaves(drv["params"]), tree_leaves(ref["params"])):
            torch.testing.assert_close(a[c * D], b[c], **tol)
    for a, b in zip(tree_leaves(drv["center"]), tree_leaves(ref["center"])):
        torch.testing.assert_close(a[0], b, **tol)


def test_clientize_declientize_and_interval_gate():
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    from repro.core import hierarchy as jh

    cl = clientize(params, 3)
    jcl = jh.clientize({k: jnp.asarray(v.numpy()) for k, v in params.items()}, 3)
    for k in params:
        np.testing.assert_array_equal(cl[k].numpy(), np.asarray(jcl[k]))
    cl["w"][1] += 3.0
    back = declientize(cl, 3)
    np.testing.assert_allclose(back["w"].numpy(), np.asarray(jh.declientize(
        {k: jnp.asarray(v.numpy()) for k, v in cl.items()}, 3)["w"]))
    assert clientize(params, 1) is params
    steps = torch.arange(7)
    np.testing.assert_array_equal(should_elastic_sync(steps, 3).numpy(),
                                  np.asarray(jh.should_elastic_sync(jnp.arange(7), 3)))


def test_engine_exchange_selection(tmodel):
    spec = ttrain.grad_spec(tmodel)
    flat = make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig(mode="mpi_esgd",
                                                           num_clients=2), spec=spec)
    per_leaf = make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig(
        mode="mpi_esgd", num_clients=2, flat_exchange=False), spec=spec)
    custom = make_sync_engine(tsgd.sgd(0.1), SyncConfig(mode="mpi_esgd",
                                                        num_clients=2))
    assert flat.flat_exchange and not per_leaf.flat_exchange
    assert type(custom) is SyncEngine and custom.flat_exchange
    params = clientize(tmodel.init(device="cpu"), 2)
    center = tree_map(lambda t: t[0] * 0.5, params)
    a = flat.exchange_multiclient(params, center, 0.25)
    b = per_leaf.exchange_multiclient(params, center, 0.25)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    # C > 1: each client's state is the local (p = 1) geometry
    state = ttrain.make_train_state(tmodel, tsgd.sgd(0.1, 0.9), SyncConfig(
        mode="mpi_esgd", num_clients=2), device="cpu")
    flat.check_opt_layout(state["opt"], 2)
    with pytest.raises(ValueError, match="elements per stream"):
        flat.check_opt_layout(state["opt"][:, :128].contiguous(), 2)


def test_unported_paths_raise_naming_their_slice(tmodel):
    opt = tsgd.sgd(0.1, 0.9)
    sync = SyncConfig(mode="mpi_sgd", policy=CollectivePolicy(method="ring"))
    overlap = SyncConfig(policy=CollectivePolicy(method="ring", overlap=True))
    # backward overlap is ported: the driver and the train step build and
    # step (tests/test_torch_overlap.py holds them against the reference)
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.int32),
             "labels": torch.ones(4, 8, dtype=torch.int32)}
    state = TSD.make_driver_state(tmodel, opt, overlap, 2, device="cpu")
    state, met = TSD.make_emulated_step(tmodel, opt, overlap, 2)(
        state, TSD.shard_batch(batch, 2))
    assert int(state["step"][0]) == 1 and torch.isfinite(met["loss"])
    state = ttrain.make_train_state(tmodel, opt, overlap, device="cpu")
    state, met = ttrain.make_train_step(tmodel, opt, overlap, device="cpu")(
        state, batch)
    assert int(state["step"]) == 1 and torch.isfinite(met["loss"])
    # drive(faults=) runs now: with no batches the schedule never fires
    assert TSD.drive(tmodel, opt, sync, [], p=2, device="cpu",
                     faults="kill@1:unit=0")[1] == []
    # the process mesh is ported (tests/test_torch_sharded_driver.py); a
    # mesh without the driver's axes, and faults on a mesh, are refused
    with pytest.raises(ValueError, match="fit neither driver layout"):
        TSD.make_sharded_step(tmodel, opt, sync, mesh=SimpleNamespace(shape={"x": 2}))
    with pytest.raises(ValueError, match="vmap emulation only"):
        TSD.drive(tmodel, opt, sync, [], mesh=SimpleNamespace(shape={"dev": 2}),
                  device="cpu", faults="kill@1:unit=0")
    world = TSD.driver_world(sync, (2, 2))
    assert world.resized(1, "pod").sizes == (1, 2)
    # one schedule bucket's leg over the 2-axis world: pod, then data
    _, sched = ttrain.overlap_schedule(tmodel, overlap, 4)
    chunk = world.reduce_scatter_bucket(torch.ones(2, 2, sched.sizes[0]), sched, 0)
    assert torch.equal(chunk, torch.full((2, 2, sched.chunks[0]), 4.0))
    from repro_torch.core.elastic import elastic_exchange_packed

    # the one refusal the reference also makes: the removed int8 alias
    with pytest.raises(ValueError, match="wire_dtype='int8'"):
        elastic_exchange_packed({}, {}, 0.5, compress=True)
    # the tensor collectives are ported (the PS-tier slice): a stacked
    # tree over the 2-axis world sums over all four devices
    total = world.tensor_allreduce({"w": torch.ones(2, 2, 5)})["w"]
    assert torch.equal(total, torch.full((2, 2, 5), 4.0))


def test_drive_loop_learns(tmodel):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    sync = SyncConfig(mode="mpi_esgd", num_clients=2, esgd_interval=4,
                      esgd_alpha=0.5)
    pipe = TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=32,
                                    batch_size=8, steps_per_epoch=12))
    _, hist = TSD.drive(tmodel, tsgd.sgd(0.1, 0.9), sync, pipe.epoch(0), p=2,
                        device="cpu", log_every=1)
    assert len(hist) == 12
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_exchange_on_the_trivial_group_matches_reference(dtype):
    """p = 1: both kernels over the whole packed buffer, no collective."""
    from repro.core import flatbuf as jfb
    from repro.core.elastic import elastic_exchange_sharded as jexchange
    from repro_torch.core import flatbuf as tfb
    from repro_torch.core.elastic import elastic_exchange_sharded as texchange

    rng = np.random.default_rng(3)
    w = {"a": rng.standard_normal((5, 70)).astype(np.float32),
         "b": {"c": rng.standard_normal(9).astype(np.float32)}}
    c = jax.tree.map(lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32), w)
    w, c = (jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), t) for t in (w, c))
    jw, jc = jexchange(jfb.spec_for(w), w, c, 0.3)
    tw_in = params_from_numpy(jax.tree.map(np.asarray, w))
    tw, tc = texchange(tfb.spec_for(tw_in), tw_in,
                       params_from_numpy(jax.tree.map(np.asarray, c)), 0.3)
    _close(jw, tw, rtol=0, atol=0)
    _close(jc, tc, rtol=0, atol=0)
