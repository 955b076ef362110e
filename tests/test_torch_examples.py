"""The port's modules for the reference's three examples
(``repro_torch.launch.quickstart``, ``.esgd_multipod``, ``.serve_batched``)
held against ``examples/*.py`` on the reference's weights, on the CPU.

- quickstart: per-step losses of the mpi-SGD run within rtol 1e-3 of the
  reference's run (tests/test_torch_train.py's tolerance), the checkpoint
  round trip ``==`` the trained params, and the greedy tokens ``==`` the
  reference's ``BatchedServer`` on the port's trained params;
- esgd_multipod: ``run_mode`` against the example's own ``run_mode``
  (imported by path), mpi-ESGD at C = 2, 8 steps, an exchange every 4, on
  both drivers: losses within rtol 1e-4, the consensus params within
  rtol 1e-3 / atol 1e-5 (tests/test_torch_esgd_train.py's tolerances);
- serve_batched: 4-token greedy continuations of the example's prompts
  ``==`` the reference's server, for the three archs (reduced: f32);
- each ``main`` runs to its end with ``--device cpu``, and without it
  (the card) raises when there is none.
"""
import importlib
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSync  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.serve import BatchedServer as JBatchedServer  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import esgd_multipod, quickstart, serve_batched  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
torch.set_num_threads(2)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
QUICK_STEPS = 6


def _example(name):
    """``examples/<name>.py`` as a module (the folder is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _init(arch):
    """The reduced reference model and its weights at key 0, as numpy."""
    jmodel = jbuild_model(jreduced(jget_config(arch)))
    return jmodel, jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))


def _close(ref, port, rtol, atol):
    want = jax.tree_util.tree_leaves(ref)
    got = tree_leaves(params_to_numpy(port))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol)


def test_quickstart_matches_reference(capsys):
    """The example's sequence: the reference's steps (its ``main`` as
    written, jitted) against ``quickstart.run`` from the same weights."""
    jmodel, init = _init("qwen2-0.5b")
    opt, sync = jsgd.sgd(0.1, momentum=0.9), JSync(mode="mpi_sgd", num_clients=1)
    state = jtrain.make_train_state(jmodel, opt, sync, jax.random.key(0))
    step = jax.jit(jtrain.make_train_step(jmodel, opt, sync, None))
    pipe = JTokenPipeline(JDataConfig(seed=0, vocab_size=256, seq_len=64,
                                      batch_size=8, steps_per_epoch=QUICK_STEPS))
    jlosses = []
    for batch in pipe.epoch(0):
        state, met = step(state, batch)
        jlosses.append(float(met["loss"]))

    out = quickstart.run(steps=QUICK_STEPS, device="cpu",
                         params=params_from_numpy(init))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-3)
    assert out["losses"][-1] < out["losses"][0]
    assert out["step"] == QUICK_STEPS
    for a, b in zip(tree_leaves(out["restored"]), tree_leaves(out["params"])):
        assert torch.equal(a, b)
    assert out["floor"] == pytest.approx(pipe.optimal_xent(), rel=1e-12)
    np.testing.assert_array_equal(out["prompts"].numpy(),
                                  np.asarray(pipe.batch_at(1, 0)["tokens"][:2, :8]))
    # the reference's server on the port's trained params
    trained = jax.tree.map(jnp.asarray, params_to_numpy(out["params"]))
    srv = JBatchedServer(jmodel, trained, batch=2, max_seq=96)
    want = srv.generate(jnp.asarray(out["prompts"].numpy()), steps=12)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(want))
    printed = capsys.readouterr().out
    assert "checkpoint round-trip ok (step 6)" in printed
    assert f"params={out['nparams']:,}" in printed


@pytest.mark.parametrize("driver", ["vmap", "shard"])
def test_esgd_run_mode_matches_example(driver):
    steps, interval = 8, 4
    ex = _example("esgd_multipod")
    jmodel, init = _init("qwen2-0.5b")
    jpipes = [JTokenPipeline(JDataConfig(seed=0, vocab_size=256, seq_len=48,
                                         batch_size=4, steps_per_epoch=steps, shard=c))
              for c in range(2)]
    jlosses, jparams = ex.run_mode(
        jmodel, JSync(mode="mpi_esgd", num_clients=2, esgd_alpha=0.5,
                      esgd_interval=interval),
        jpipes, steps, lr=0.1, driver=driver)
    tpipes = [TokenPipeline(DataConfig(seed=0, vocab_size=256, seq_len=48,
                                       batch_size=4, steps_per_epoch=steps, shard=c))
              for c in range(2)]
    tlosses, tparams = esgd_multipod.run_mode(
        build_model(reduced(get_config("qwen2-0.5b"))),
        SyncConfig(mode="mpi_esgd", num_clients=2, esgd_alpha=0.5,
                   esgd_interval=interval),
        tpipes, steps, lr=0.1, driver=driver, params=params_from_numpy(init),
        device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    _close(jax.tree.map(np.asarray, jparams), tparams, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("arch", serve_batched.ARCHS)
def test_serve_batched_matches_reference(arch):
    jmodel, init = _init(arch)
    prompts = np.asarray(jax.random.randint(jax.random.key(1), (4, 6), 0,
                                            jmodel.cfg.vocab_size))
    srv = JBatchedServer(jmodel, jax.tree.map(jnp.asarray, init), batch=4, max_seq=64)
    want = np.asarray(srv.generate(jnp.asarray(prompts), steps=4))
    got = serve_batched.serve_arch(arch, device="cpu", params=params_from_numpy(init),
                                   prompts=torch.from_numpy(prompts), steps=4)
    assert got["arch_type"] == jmodel.cfg.arch_type
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


def test_mains_run_on_the_cpu(capsys):
    q = quickstart.main(["--device", "cpu", "--steps", "3"])
    assert q["device"].type == "cpu" and len(q["losses"]) == 3
    assert 0 <= int(q["tokens"].min()) and int(q["tokens"].max()) < q["model"].cfg.vocab_size
    e = esgd_multipod.main(["--device", "cpu", "--steps", "4", "--interval", "2"])
    assert len(e["sgd_losses"]) == len(e["esgd_losses"]) == 4
    assert e["syncs"] == (4, 2)
    s = serve_batched.main(["--device", "cpu"])
    assert set(s) == set(serve_batched.ARCHS)
    for res in s.values():
        assert tuple(res["tokens"].shape) == (4, 16)
        assert int(res["tokens"].max()) < res["vocab_size"]
    printed = capsys.readouterr().out
    assert "checkpoint round-trip ok (step 3)" in printed
    assert "cross-client syncs: mpi_sgd=4 mpi_esgd=2 (2x fewer)" in printed
    assert printed.count("tok/s on CPU") == 3


@pytest.mark.parametrize("mod", [quickstart, esgd_multipod, serve_batched])
def test_mains_default_to_the_card(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
