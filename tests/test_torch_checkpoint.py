"""The npz checkpoint format as the second weight bridge: a checkpoint the
reference writes restores exactly in the port, and the reverse."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSyncConfig  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import path_str, tree_flatten_with_path, tree_leaves  # noqa: E402

torch.set_num_threads(2)
jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")

OPTS = {"sgd": dict(lr=0.1, momentum=0.9), "adamw": dict(lr=1e-3),
        "adagrad": dict(lr=1e-2)}


def _states(name, dtype="float32"):
    import dataclasses

    jcfg = dataclasses.replace(jreduced(jget_config("qwen2-0.5b")), dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), dtype=dtype)
    jopt = jsgd.get_optimizer(name, **OPTS[name])
    jstate = jtrain.make_train_state(jbuild_model(jcfg), jopt, JSyncConfig(),
                                     jax.random.key(1))
    # a non-trivial optimizer state and step count
    jstate = jax.tree.map(lambda a: a + jnp.asarray(3, a.dtype), jstate)
    topt = tsgd.get_optimizer(name, **OPTS[name])
    tstate = ttrain.make_train_state(build_model(tcfg), topt, SyncConfig(),
                                     device="cpu")
    return jstate, tstate


def _assert_equal_trees(ported, reference):
    want = jax.tree_util.tree_flatten_with_path(reference)[0]
    got = tree_flatten_with_path(params_to_numpy(ported))[0]
    assert [path_str(p) for p, _ in got] == \
        [jckpt._SEP.join(jckpt._path_str(e) for e in p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and g.shape == np.asarray(w).shape
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_reference_checkpoint_restores_in_port(tmp_path, name, dtype):
    jstate, tstate = _states(name, dtype)
    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, jstate, step=7)
    restored, meta = tckpt.restore_checkpoint(path, tstate)
    assert meta["step"] == 7
    _assert_equal_trees(restored, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_port_checkpoint_restores_in_reference(tmp_path, name, dtype):
    jstate, tstate = _states(name, dtype)
    gen = torch.Generator().manual_seed(0)
    for leaf in tree_leaves(tstate):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    tstate["step"] = torch.tensor(11, dtype=torch.int32)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, tstate, step=11)
    restored, meta = jckpt.restore_checkpoint(path, jstate)
    assert meta["step"] == 11
    _assert_equal_trees(tstate, restored)


def test_restore_validates_like_the_reference(tmp_path):
    _, tstate = _states("sgd")
    path = str(tmp_path / "p.npz")
    tckpt.save_checkpoint(path, tstate["params"])
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore_checkpoint(path, {"nope": torch.zeros(2)})
    bad = dict(tstate["params"], final_norm=torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, bad)
    assert tckpt.checkpoint_path("d", 4) == jckpt.checkpoint_path("d", 4)
