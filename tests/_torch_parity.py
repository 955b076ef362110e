"""Shared driver for the port's train-step parity tests: the same
quickstart run (reduced qwen2-0.5b, bigram data at vocab 256, seq 64,
batch 8, mpi-SGD with one client) through the reference under
``jax.jit`` and through the port on the CPU, from the same weights."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget_config, reduced as jreduced
from repro.core.hierarchy import SyncConfig as JSyncConfig
from repro.data.pipeline import DataConfig as JDataConfig, TokenPipeline as JTokenPipeline
from repro.launch import train as jtrain
from repro.models.model import build_model as jbuild_model
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")

DATA = dict(seed=0, vocab_size=256, seq_len=64, batch_size=8)
STATE_DTYPES = {None: (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def reference_run(name, steps, *, state_dtype=None, microbatch=1,
                  fused_update=True, seed=0, **hyper):
    """Per-step losses, final params and final state of the reference."""
    model = jbuild_model(jreduced(jget_config("qwen2-0.5b")))
    kw = dict(hyper)
    if STATE_DTYPES[state_dtype][0] is not None:
        kw["state_dtype"] = STATE_DTYPES[state_dtype][0]
    opt = jsgd.get_optimizer(name, **kw)
    sync = JSyncConfig(fused_update=fused_update)
    state = jtrain.make_train_state(model, opt, sync, jax.random.key(seed))
    step = jax.jit(jtrain.make_train_step(model, opt, sync, None,
                                          microbatch=microbatch))
    pipe = JTokenPipeline(JDataConfig(**DATA))
    init = jax.tree.map(np.asarray, state["params"])
    losses = []
    for i in range(steps):
        state, met = step(state, pipe.batch_at(0, i))
        losses.append(float(met["loss"]))
    return init, np.array(losses), jax.tree.map(np.asarray, state)


def port_run(init_params, name, steps, *, state_dtype=None, microbatch=1,
             fused_update=True, **hyper):
    """The same run through the port on the CPU from ``init_params``."""
    model = build_model(reduced(get_config("qwen2-0.5b")))
    kw = dict(hyper)
    if STATE_DTYPES[state_dtype][1] is not None:
        kw["state_dtype"] = STATE_DTYPES[state_dtype][1]
    opt = tsgd.get_optimizer(name, **kw)
    sync = SyncConfig(fused_update=fused_update)
    state = ttrain.make_train_state(model, opt, sync, device="cpu")
    state["params"] = params_from_numpy(init_params)
    step = ttrain.make_train_step(model, opt, sync, microbatch=microbatch,
                                  device="cpu")
    pipe = TokenPipeline(DataConfig(**DATA))
    losses = []
    for i in range(steps):
        state, met = step(state, pipe.batch_at(0, i))
        losses.append(float(met["loss"]))
    return np.array(losses), state


def assert_params_close(ref_params, port_params, rtol, atol):
    got = params_to_numpy(port_params)
    for (path, want), have in zip(jax.tree_util.tree_flatten_with_path(ref_params)[0],
                                  jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(have, np.float32),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(path))
