"""The port's emulated shard driver (``make_driver_state`` +
``make_emulated_step``) against the reference's vmap-emulated driver on
the reduced qwen2-0.5b, from the same weights and batches: mpi_sgd at
p=2 and (2, 2) with sgd and adamw, mpi_esgd at p=2 and (2, 2) with sgd,
each over the f32 and the int8 wire, 3 steps (the esgd runs cross an
exchange at interval 2).

Tolerances: per-step losses rtol 1e-4; the stacked state layout (leaf
shapes, optimizer shard lengths) equal; final stacked params, centers and
optimizer shards rtol 1e-3 / atol 1e-5 over the f32 wire (AdamW at eps
1e-5, as tests/test_torch_train.py holds it). Over the int8 wire the
codec is discontinuous: the two frameworks' gradients differ in the last
bits (matmul summation order), so a value next to a rounding boundary
takes the neighbouring code, one step of absmax/127, in one framework
and not the other. There the final state is held to the reference's own
band for a quantized leg (``tests/test_overlap.py``: rtol 1e-2,
atol 2e-3) with SGD. AdamW normalises every coordinate by its own
gradient, so a flipped code can move its coordinate by up to 2·lr per
step: there every element is held to atol 2·lr per step taken, and the
f32 tolerance (rtol 1e-3 / atol 1e-5) must hold for all but 1 % of each
state key's elements and all but 20 % of any one leaf's (measured: at
most 0.55 % of the params and 0.17 % of m/v; at most 8.6 % of a
256-element norm or bias leaf, whose blocks share a large absmax). A
skipped or sign-flipped update moves every element and fails both.
Exactness of the int8 hops on identical inputs is held in
tests/test_torch_collectives.py.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core.comm import CollectivePolicy as JPolicy  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSync  # noqa: E402
from repro.launch import shard_driver as JSD  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core.comm import CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.launch import shard_driver as TSD  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")
torch.set_num_threads(2)

STEPS = 3
HYPER = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=3e-3, eps=1e-5)}
CASES = ([("mpi_sgd", p, o, w) for p in (2, (2, 2)) for o in ("sgd", "adamw")
          for w in (None, "int8")]
         + [("mpi_esgd", p, "sgd", w) for p in (2, (2, 2)) for w in (None, "int8")])


@pytest.fixture(scope="module")
def models():
    return (jbuild_model(jreduced(jget_config("qwen2-0.5b"))),
            build_model(reduced(get_config("qwen2-0.5b"))))


def _batch(seed=0, B=8, S=32):
    toks = np.random.default_rng(seed).integers(0, 1024, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _syncs(mode, p, wire):
    C = (p[0] if isinstance(p, tuple) else p) if mode == "mpi_esgd" else 1
    kw = dict(mode=mode, num_clients=C, esgd_interval=2, esgd_alpha=0.5)
    pol = dict(method="ring", num_rings=2, wire_dtype=wire)
    return JSync(policy=JPolicy(**pol), **kw), SyncConfig(policy=CollectivePolicy(**pol), **kw)


def _bridge(jstate, tstate):
    """The reference's initial params (and centers) into the port's state."""
    for key in ("params", "center"):
        if key in jstate:
            tstate[key] = params_from_numpy(jax.tree.map(np.asarray, jstate[key]))
    return tstate


def _pairs(ref, port):
    want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), ref))
    got = [np.asarray(a, np.float32) for a in jax.tree.leaves(params_to_numpy(port))]
    assert len(want) == len(got)
    return list(zip(want, got))


def _close(ref, port, rtol, atol, what):
    for w, g in _pairs(ref, port):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _close_but_flips(ref, port, band, what, key_frac=0.01, leaf_frac=0.2):
    """Every element within ``band``; the f32 tolerance for all but
    ``key_frac`` of the key's elements and ``leaf_frac`` of each leaf's."""
    off = total = 0
    for w, g in _pairs(ref, port):
        np.testing.assert_allclose(g, w, rtol=0, atol=band, err_msg=what)
        bad = int((np.abs(g - w) > 1e-5 + 1e-3 * np.abs(w)).sum())
        assert bad <= leaf_frac * w.size, (what, w.shape, bad)
        off, total = off + bad, total + w.size
    assert off <= key_frac * total, (what, off, total)


def run_both(models, mode, p, opt_name, wire, steps=STEPS):
    jmodel, tmodel = models
    jopt = jsgd.get_optimizer(opt_name, **HYPER[opt_name])
    topt = tsgd.get_optimizer(opt_name, **HYPER[opt_name])
    jsync, tsync = _syncs(mode, p, wire)
    jst = JSD.make_driver_state(jmodel, jopt, jsync, p, jax.random.key(1))
    tst = _bridge(jst, TSD.make_driver_state(tmodel, topt, tsync, p, device="cpu"))
    jstep = jax.jit(JSD.make_emulated_step(jmodel, jopt, jsync, p))
    tstep = TSD.make_emulated_step(tmodel, topt, tsync, p)
    jl, tl = [], []
    for i in range(steps):
        b = _batch(i)
        jst, jm = jstep(jst, JSD.shard_batch({k: jnp.asarray(v) for k, v in b.items()}, p))
        tst, tm = tstep(tst, TSD.shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, p))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return np.array(jl), np.array(tl), jst, tst


@pytest.mark.parametrize("mode,p,opt_name,wire", CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_driver_matches_reference(models, mode, p, opt_name, wire):
    jl, tl, jst, tst = run_both(models, mode, p, opt_name, wire)
    assert sorted(jst) == sorted(tst)
    for key in jst:
        want = [tuple(a.shape) for a in jax.tree.leaves(jst[key])]
        got = [tuple(a.shape) for a in tree_leaves(tst[key])]
        assert got == want, key
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(tst["step"][0]) == STEPS
    tol = dict(rtol=1e-3, atol=1e-5) if wire is None else dict(rtol=1e-2, atol=2e-3)
    for key in ("params", "center", "opt"):
        if key not in jst:
            continue
        if wire is not None and opt_name == "adamw":
            _close_but_flips(jst[key], tst[key], what=key,
                             band=2 * HYPER[opt_name]["lr"] * STEPS)
        else:
            _close(jst[key], tst[key], what=key, **tol)


def test_driver_state_layout_and_guards(models):
    _, tmodel = models
    opt = tsgd.sgd(0.1, 0.9)
    for mode, p in (("mpi_sgd", 4), ("mpi_sgd", (2, 2)), ("mpi_esgd", 4),
                    ("mpi_esgd", (2, 2))):
        jsync, tsync = _syncs(mode, p, None)
        jst = JSD.make_driver_state(models[0], jsgd.sgd(0.1, momentum=0.9),
                                    jsync, p, jax.random.key(0))
        tst = TSD.make_driver_state(tmodel, opt, tsync, p, device="cpu")
        assert sorted(jst) == sorted(tst)
        for key in jst:
            assert [tuple(a.shape) for a in tree_leaves(tst[key])] == \
                [tuple(a.shape) for a in jax.tree.leaves(jst[key])]
    with pytest.raises(ValueError, match="flat fused substrate"):
        TSD.make_driver_state(tmodel, tsgd.sgd(0.1), SyncConfig(), 2, device="cpu")
    with pytest.raises(ValueError, match="one client per device"):
        TSD.make_driver_state(tmodel, opt, SyncConfig(mode="mpi_esgd", num_clients=3),
                              2, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        TSD.shard_batch({"tokens": torch.zeros(6, 4)}, 4)


def test_driver_counts_wire_bytes_of_the_cost_model(models):
    """The backend's byte counter over one step: the grad and param legs
    every step, plus the elastic leg on an exchange step."""
    from repro_torch.core import cost_model, flatbuf
    from repro_torch.core.collectives import WireMeter
    from repro_torch.launch.train import grad_spec

    _, tmodel = models
    spec = grad_spec(tmodel)
    opt = tsgd.sgd(0.1, 0.9)
    for mode, p, wire in (("mpi_sgd", 4, "int8"), ("mpi_esgd", (2, 2), "int8"),
                          ("mpi_esgd", (2, 2), "bf16")):
        _, tsync = _syncs(mode, p, wire)
        meter = WireMeter()
        st = TSD.make_driver_state(tmodel, opt, tsync, p, device="cpu")
        step = TSD.make_emulated_step(tmodel, opt, tsync, p, meter=meter)
        gp, ep = (np.prod(p), 0) if mode == "mpi_sgd" else (p[1], p[0])
        _, gtotal = flatbuf.shard_geometry(spec.size, gp, 2)
        per_step = 2 * cost_model.grad_leg_bytes(gtotal * 4, gp, wire)
        _, etotal = flatbuf.shard_geometry(spec.size, max(ep, 1), 2)
        exch = cost_model.elastic_leg_bytes(etotal * 4, ep, wire) if ep else 0
        for i in range(2):   # step 0 exchanges (interval 2), step 1 does not
            meter.reset()
            st, _ = step(st, TSD.shard_batch(
                {k: torch.from_numpy(v) for k, v in _batch(i).items()}, p))
            assert meter.bytes == per_step + (exch if i == 0 else 0), (mode, p, i)
