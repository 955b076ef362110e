"""The shard driver over a process mesh (``launch/shard_driver.
make_sharded_step``, ``drive(mesh=)``): gloo ranks on the CPU, one
process each, at p = 4 and (2, 2), on the reduced qwen2-0.5b from the
reference's initial weights.

Each case — mpi_sgd and mpi_esgd (an exchange every 2 steps) × sgd /
adamw / adagrad at both layouts, and at p = 4 mpi_sgd over the int8
wire, with backward overlap and with microbatch 2 — runs 3 steps in the
ranks and through ``make_emulated_step`` here, this process on one BLAS
thread as the ranks are: the gathered rank blocks (params, optimizer
state, center, step), the metrics and every rank's wire bytes are held
``==`` to the emulated driver's, and the bytes to ``core.cost_model``.
One case per mode is held to the reference's single-process
``make_train_step(..., None)`` losses within rtol 1e-4, as its selftest
holds its shard_map driver. Then ``SyncConfig.validate(mesh)``'s
messages against the reference's on duck-typed meshes, and the
refusal that stays (faults on a mesh); ``make_sync_engine(mesh)`` is the
GSPMD path's per-leaf engine.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_mesh as TM  # noqa: E402
from _torch_net import one_thread  # noqa: E402
from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSync  # noqa: E402
from repro.launch import shard_driver as JSD  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import cost_model, flatbuf  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.core.sync_engine import make_sync_engine  # noqa: E402
from repro_torch.launch import shard_driver as TSD  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.launch.train import grad_spec  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")

STEPS = 3
OPTS = ("sgd", "adamw", "adagrad")
LAYOUTS = {"p4": ((4,), ("dev",), 4), "p2x2": ((2, 2), ("pod", "data"), (2, 2))}


def _cases(layout):
    pods = 2 if layout == "p2x2" else 4
    cases = [dict(mode="mpi_sgd", opt=o) for o in OPTS]
    cases += [dict(mode="mpi_esgd", opt=o, clients=pods) for o in OPTS]
    if layout == "p4":
        cases += [dict(mode="mpi_sgd", opt="sgd", wire="int8"),
                  dict(mode="mpi_sgd", opt="sgd", overlap=True),
                  dict(mode="mpi_sgd", opt="sgd", microbatch=2)]
    return cases


def _name(case):
    extra = [f"{k}={v}" for k, v in case.items() if k not in ("mode", "opt", "clients")]
    return "-".join([case["mode"], case["opt"]] + extra)


def _batches():
    out = []
    for i in range(STEPS):
        toks = np.random.default_rng(i).integers(0, 1024, (8, 32)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(np.roll(toks, -1, axis=1))})
    return out


@pytest.fixture(scope="module")
def jmodel():
    return jbuild_model(jreduced(jget_config("qwen2-0.5b")))


@pytest.fixture(scope="module")
def weights(jmodel):
    """The reference's initial params, bridged."""
    return params_from_numpy(jax.tree.map(np.asarray, jmodel.init(jax.random.key(1))))


@pytest.fixture(scope="module")
def runs(weights):
    """Every layout's cases once in the ranks (one spawn a layout) and
    through the emulated driver here, on one BLAS thread as the ranks
    run (``_torch_net.one_thread``: with more, a loaded machine rounds
    the products differently from call to call)."""
    out = {}
    batches = _batches()
    with one_thread():
        for layout, (shape, axes, p) in LAYOUTS.items():
            cases = _cases(layout)
            ranks = spawn_ranks(TM.driver_rank, shape, axes, backend="gloo",
                                device="cpu", args=(cases, weights, batches))
            for i, case in enumerate(cases):
                out[(layout, _name(case))] = (
                    case, p, [r[i] for r in ranks],
                    TM.emulated_case(case, p, weights, batches))
    return out


CASES = [(lay, _name(c)) for lay in LAYOUTS for c in _cases(lay)]


@pytest.mark.parametrize("layout,name", CASES, ids=[f"{a}-{b}" for a, b in CASES])
def test_sharded_step_equals_emulated(runs, layout, name):
    case, p, ranks, emu = runs[(layout, name)]
    got = TSD.gather_blocks([r["state"] for r in ranks])
    assert sorted(got) == sorted(emu["state"])
    for key in emu["state"]:
        g, w = tree_leaves(got[key]), tree_leaves(emu["state"][key])
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape and a.dtype == b.dtype, key
            assert torch.equal(a, b), key
    assert [int(s) for s in got["step"]] == [STEPS] * len(got["step"])
    for r in ranks:
        assert r["wire"] == emu["wire"]
        for m_r, m_e in zip(r["metrics"], emu["metrics"]):
            assert m_r.keys() == m_e.keys()
            for k in m_e:
                assert torch.equal(m_r[k], m_e[k]), k
    losses = [float(m["loss"]) for m in emu["metrics"]]
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("layout,name", [c for c in CASES if "overlap" not in c[1]
                                         and "microbatch" not in c[1]],
                         ids=lambda v: str(v))
def test_sharded_wire_bytes_equal_cost_model(runs, layout, name):
    """Every rank's bytes a step: the gradient and param legs, plus the
    elastic leg on an exchange step (0 and 2 at interval 2)."""
    case, p, ranks, _ = runs[(layout, name)]
    spec = grad_spec(TM.model())
    wire = case.get("wire")
    shape = p if isinstance(p, tuple) else (p,)
    if case["mode"] == "mpi_sgd":
        gp, ep = int(np.prod(shape)), 0
    else:
        gp, ep = (shape[1], shape[0]) if len(shape) == 2 else (1, shape[0])
    per_step = 0
    if gp > 1:
        _, gtotal = flatbuf.shard_geometry(spec.size, gp, 2)
        per_step = (cost_model.grad_leg_bytes(gtotal * 4, gp, wire)
                    + cost_model.param_leg_bytes(gtotal * 4, gp, wire))
    _, etotal = flatbuf.shard_geometry(spec.size, max(ep, 1), 2)
    exch = cost_model.elastic_leg_bytes(etotal * 4, ep, wire) if ep else 0
    want = [per_step + (exch if i % 2 == 0 else 0) for i in range(STEPS)]
    for r in ranks:
        assert r["wire"] == want


@pytest.mark.parametrize("mode", ["mpi_sgd", "mpi_esgd"])
def test_sharded_losses_match_reference_train_step(runs, jmodel, mode):
    """The p = 4 sgd case's losses == the reference's single-process step
    (C = 1, or the C = 4 multi-client step) within rtol 1e-4."""
    case, p, ranks, _ = runs[("p4", _name(dict(mode=mode, opt="sgd")))]
    jopt = jsgd.sgd(0.1, momentum=0.9)
    jsync = JSync(mode=mode, num_clients=1 if mode == "mpi_sgd" else 4,
                  esgd_interval=2, esgd_alpha=0.5)
    ref = jtrain.make_train_state(jmodel, jopt, jsync, jax.random.key(1))
    ref_step = jax.jit(jtrain.make_train_step(jmodel, jopt, jsync, None))
    want = []
    for b in _batches():
        jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        ref, m = ref_step(ref, jb if jsync.num_clients <= 1 else JSD.shard_batch(jb, 4))
        want.append(float(m["loss"]))
    got = [float(m["loss"]) for m in ranks[0]["metrics"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("shape", [{"dev": 4}, {"pod": 2, "data": 2}, {"pod": 4, "data": 2},
                                   {"data": 4, "model": 2}])
@pytest.mark.parametrize("kw", [dict(), dict(mode="mpi_esgd", num_clients=2),
                                dict(policy="overlap")], ids=str)
def test_validate_mesh_messages_equal_reference(shape, kw):
    from repro.core.comm import CollectivePolicy as JPolicy
    from repro_torch.core.comm import CollectivePolicy

    if kw.get("policy") == "overlap":
        j = JSync(policy=JPolicy(method="ring", overlap=True))
        t = SyncConfig(policy=CollectivePolicy(method="ring", overlap=True))
    else:
        j, t = JSync(**kw), SyncConfig(**kw)
    mesh = SimpleNamespace(shape=dict(shape))
    want = _message(lambda: j.validate(mesh))
    assert _message(lambda: t.validate(mesh)) == want
    assert _message(lambda: t.validate(None)) == _message(lambda: j.validate(None))
    if kw.get("num_clients") == 2 and shape == {"pod": 2, "data": 2}:
        assert want is None


def test_refusals_that_stay(jmodel):
    model, opt = TM.model(), tsgd.sgd(0.1, 0.9)
    sync = SyncConfig(mode="mpi_sgd")
    mesh = SimpleNamespace(shape={"dev": 4})
    jmesh = SimpleNamespace(shape={"dev": 4})
    want = _message(lambda: JSD.drive(jmodel, jsgd.sgd(0.1, momentum=0.9), JSync(), [],
                                      mesh=jmesh, faults="kill@1:unit=0"))
    assert want is not None and "vmap emulation only" in want
    assert _message(lambda: TSD.drive(model, opt, sync, [], mesh=mesh,
                                      faults="kill@1:unit=0")) == want
    bad = SimpleNamespace(shape={"x": 4})
    assert _message(lambda: TSD.make_sharded_step(model, opt, sync, bad)) == \
        _message(lambda: JSD._mesh_geometry(bad))
    # the GSPMD path is ported: with a mesh the engine is the per-leaf one
    engine = make_sync_engine(opt, sync, mesh, spec=grad_spec(model))
    assert not engine.fused and not engine.flat_exchange
