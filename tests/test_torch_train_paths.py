"""The port's train-step variants against the reference (default-eps
adaptive optimizers, bf16 state streams, weight decay, microbatching, the
per-leaf path) and its entry points' contracts (CUDA by default, the CLI,
the still unported paths, checkpoint resume)."""
import importlib

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from _torch_parity import assert_params_close, port_run, reference_run  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core.comm import CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.core.sync_engine import FlatEngine, SyncEngine, make_sync_engine  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)
tsgd = importlib.import_module("repro_torch.optim.sgd")


@pytest.mark.parametrize("name,hyper", [("adamw", dict(lr=3e-3)),
                                        ("adagrad", dict(lr=1e-2))])
def test_default_eps_losses(name, hyper):
    init, jlosses, _ = reference_run(name, 20, **hyper)
    tlosses, _ = port_run(init, name, 20, **hyper)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)


@pytest.mark.parametrize("name,hyper", [
    ("adamw", dict(lr=3e-3, eps=1e-5, weight_decay=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
])
def test_weight_decay_matches_reference(name, hyper):
    """SGD's decay is coupled into g before the kernel, AdamW's is
    decoupled inside it."""
    init, jlosses, jstate = reference_run(name, 5, **hyper)
    tlosses, tstate = port_run(init, name, 5, **hyper)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert_params_close(jstate["params"], tstate["params"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name,hyper", [("adamw", dict(lr=3e-3, eps=1e-5)),
                                        ("adagrad", dict(lr=1e-2, eps=1e-4))])
def test_bf16_state_streams_match_reference(name, hyper):
    init, jlosses, jstate = reference_run(name, 5, state_dtype="bf16", **hyper)
    tlosses, tstate = port_run(init, name, 5, state_dtype="bf16", **hyper)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    buf = tstate["opt"]["mv"] if name == "adamw" else tstate["opt"]
    assert buf.dtype == torch.bfloat16


def test_microbatch_matches_reference():
    hyper = dict(lr=0.1, momentum=0.9)
    init, jlosses, jstate = reference_run("sgd", 4, microbatch=2, **hyper)
    tlosses, tstate = port_run(init, "sgd", 4, microbatch=2, **hyper)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert_params_close(jstate["params"], tstate["params"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(fused_update=False),
                                dict(state_dtype="bf16"),
                                dict(momentum=0.0)])
def test_per_leaf_path_matches_reference(kw):
    """No fused update (or SGD with a bf16 momentum / no momentum): the
    per-leaf optimizer, as in the reference."""
    hyper = dict(lr=0.1, momentum=kw.pop("momentum", 0.9))
    init, jlosses, jstate = reference_run("sgd", 5, **kw, **hyper)
    tlosses, tstate = port_run(init, "sgd", 5, **kw, **hyper)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    # a bf16 momentum rounds where f32 noise can flip one bf16 ulp
    # (2^-8 of |v| <~ 0.03 here): lr * that, accumulated over 5 steps
    atol = 1e-4 if kw.get("state_dtype") else 1e-5
    assert_params_close(jstate["params"], tstate["params"], rtol=1e-3, atol=atol)


def test_engine_selection_and_layout_guards():
    model = build_model(reduced(get_config("qwen2-0.5b")))
    spec = ttrain.grad_spec(model)
    flat = make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig(), spec=spec)
    per_leaf = make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig(fused_update=False))
    assert isinstance(flat, FlatEngine) and flat.fused
    assert type(per_leaf) is SyncEngine and not per_leaf.fused
    params = model.init(device="cpu")
    with pytest.raises(ValueError, match="flat state buffer"):
        flat.check_opt_layout(per_leaf.init_opt(params))
    with pytest.raises(ValueError, match="per-leaf update got a flat"):
        per_leaf.check_opt_layout(flat.init_opt(params))
    with pytest.raises(ValueError, match="elements per stream"):
        flat.check_opt_layout(torch.zeros(128))
    adam = make_sync_engine(tsgd.adamw(1e-3), SyncConfig(), spec=spec)
    with pytest.raises(ValueError, match="'mv', 't'"):
        adam.check_opt_layout(torch.zeros(3))
    with pytest.raises(ValueError, match="FlatBuffer spec"):
        make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig())
    # mpi_esgd and C > 1 engines exist now; overlap and meshes do not yet
    esgd = make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig(mode="mpi_esgd"),
                            spec=spec)
    assert isinstance(esgd, FlatEngine) and esgd.flat_exchange
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig(
            policy=CollectivePolicy(method="ring", overlap=True)), spec=spec)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_sync_engine(tsgd.sgd(0.1, 0.9), SyncConfig(), object(), spec=spec)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adamw"])
def test_flat_optimizer_wrappers_match_reference(name):
    """``flat_sgd``/``flat_adagrad``/``flat_adamw``: one fused update as
    a drop-in Optimizer, against the reference's wrapper."""
    from repro.core import flatbuf as jfb

    jsgd = importlib.import_module("repro.optim.sgd")
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 50)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = jax.tree.map(lambda a: (a * 0.1).astype(np.float32), tree)
    jspec = jfb.spec_for(tree)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core import flatbuf as tfb

    tparams, tgrads = params_from_numpy(tree), params_from_numpy(grads)
    tspec = tfb.spec_for(tparams)
    mk = {"sgd": lambda m, s: m.flat_sgd(0.1, 0.9, s),
          "adagrad": lambda m, s: m.flat_adagrad(0.01, s),
          "adamw": lambda m, s: m.flat_adamw(1e-3, s, weight_decay=0.1)}[name]
    jopt, topt = mk(jsgd, jspec), mk(tsgd, tspec)
    jst, tst = jopt.init(tree), topt.init(tparams)
    for _ in range(2):
        jp, jst = jopt.update(grads, jst, tree)
        tp, tst = topt.update(tgrads, tst, tparams)
        tree, tparams = jp, tp
    assert_params_close(jp, tp, rtol=1e-5, atol=1e-7)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(reduced(get_config("qwen2-0.5b")))
    opt = tsgd.sgd(0.1, 0.9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.make_train_state(model, opt, SyncConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.make_train_step(model, opt, SyncConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--steps", "1"])


@pytest.mark.parametrize("argv", [
    ["--steps", "3", "--device", "cpu"],
    ["--steps", "3", "--device", "cpu", "--optimizer", "adamw", "--lr", "0.003",
     "--state-dtype", "bf16"],
    ["--steps", "3", "--device", "cpu", "--optimizer", "adagrad", "--lr", "0.01"],
])
def test_cli_trains_on_cpu(argv, capsys):
    hist = ttrain.main(argv)
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "[train] client 0/1 arch=qwen2-0.5b" in out and "final loss" in out


@pytest.mark.parametrize("argv", [["--overlap"], ["--policy", "auto"],
                                  ["--transport", "tcp"],
                                  ["--overlap", "--wire-dtype", "int8"],
                                  ["--transport", "tcp", "--mode", "dist_esgd"]])
def test_cli_unported_flags_raise(argv, capsys):
    """The reference's flags whose paths are not ported yet exit with a
    usage error that names what is missing."""
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--steps", "1"] + argv)
    err = capsys.readouterr().err
    assert "not yet ported" in err
    assert ("backward overlap" if "--overlap" in argv else
            "autotuner" if "--policy" in argv else "socket transport") in err


def test_train_loop_checkpoint_resume_continues_the_curve(tmp_path):
    model = build_model(reduced(get_config("qwen2-0.5b")))
    opt, sync = tsgd.adamw(3e-3), SyncConfig()
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=32, batch_size=4,
                                    steps_per_epoch=4))
    full, _ = ttrain.train_loop(model, opt, sync, None, pipe.epoch(0),
                                device="cpu", checkpoint_every=2,
                                checkpoint_dir=str(tmp_path))
    assert (tmp_path / "ckpt_2.npz").exists() and (tmp_path / "ckpt_4.npz").exists()
    resumed, hist = ttrain.train_loop(model, opt, sync, None, pipe.epoch(0),
                                      device="cpu", log_every=1,
                                      restore=str(tmp_path / "ckpt_2.npz"))
    assert [h["step"] for h in hist] == [2, 3]
    assert int(resumed["step"]) == 4
    for a, b in zip(tree_leaves(resumed), tree_leaves(full)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
