"""The GSPMD path (``make_train_state(..., mesh=)`` + ``make_train_step(...,
mesh)`` on DTensor state) over gloo ranks on the CPU, one process each,
started by ``launch.mesh.spawn_ranks``; the rank workers are in
``tests/_torch_gspmd.py``.

On a (data 2, model 2) mesh: mpi_sgd with per-leaf sgd / adamw / adagrad,
``fsdp=True``, ``seq_shard_activations=True`` and microbatch 2; on a
(pod 2, data 1, model 2) mesh mpi_esgd with C = 2 (an exchange every 2
steps), where each rank's model loss must run once a step, on its own
pod's client only. Every case runs 3 steps from the seed's params and is
held to the port's one-process per-leaf step (``mesh=None``,
``fused_update=False``): losses within rtol 1e-5, and every leaf of the
gathered final state within rtol 1e-5 of the leaf's own scale (its max
|value|): the ranks sum each gradient over 'data' in another order than
one process does, which moves an element near zero by more than 1e-5 of
itself. That one-process step
is held to the reference's ``make_train_step(..., None)`` per-leaf step on
bridged weights within rtol 1e-4 on the losses.
"""
import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_gspmd as G  # noqa: E402
from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSync  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.hierarchy import clientize  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")

RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    """Both meshes' ranks, spawned side by side: {case: [rank results]}."""
    groups = {}
    for name, (shape, _) in G.CASES.items():
        groups.setdefault(shape, []).append(name)
    out, errors = {}, []

    def run(shape, names):
        try:
            res = spawn_ranks(G.mesh_rank, shape, G.AXES[len(shape)],
                              backend="gloo", device="cpu", args=(names,))
            for name in names:
                out[name] = [r[name] for r in res]
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s, n)) for s, n in groups.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.fixture(scope="module")
def one_process():
    torch.set_num_threads(1)
    return {name: G.run_case(None, case) for name, (_, case) in G.CASES.items()}


def _close(a, b):
    """Within rtol of the value and of the leaf's scale."""
    a, b = a.float().numpy(), b.float().numpy()
    scale = float(np.abs(b).max()) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("name", list(G.CASES))
def test_mesh_step_equals_one_process(ranks, one_process, name):
    """Every rank's losses, and the gathered final state, against the
    one-process per-leaf step."""
    want = one_process[name]
    for r in ranks[name]:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL)
        assert set(r["state"]) == set(want["state"])
        for key in want["state"]:
            got_l, want_l = tree_leaves(r["state"][key]), tree_leaves(want["state"][key])
            assert len(got_l) == len(want_l)
            for a, b in zip(got_l, want_l):
                assert a.shape == b.shape and a.dtype == b.dtype, key
                _close(a, b)


def test_seq_shard_equals_unsharded(ranks):
    """``seq_shard_activations=True`` trains as False does."""
    for r, s in zip(ranks["seq_shard"], ranks["sgd"]):
        np.testing.assert_allclose(r["losses"], s["losses"], rtol=RTOL)
        for a, b in zip(tree_leaves(r["state"]["params"]),
                        tree_leaves(s["state"]["params"])):
            _close(a, b)


def test_esgd_each_rank_computes_one_client(ranks):
    """Under mpi_esgd with C = 2 on 'pod', each rank's model loss runs once
    a step, on a (B / C, S) view holding its own pod's client only."""
    data = G.batches(2)
    for r in ranks["esgd_c2"]:
        assert len(r["seen"]) == G.STEPS
        for i, (shape, local) in enumerate(r["seen"]):
            assert shape == (G.BATCH // 2, G.SEQ)
            # data 1: the rank's local rows are its client's whole slice
            assert torch.equal(local, data[i]["tokens"][r["pod"]])


def test_microbatch_and_c1_views(ranks):
    """mpi_sgd: the model loss runs once a step over the whole batch
    (twice with microbatch 2, on halves); each (data 2) rank holds its
    half of the rows."""
    data = G.batches(1)
    for name, calls in (("sgd", 1), ("microbatch2", 2)):
        for r in ranks[name]:
            assert len(r["seen"]) == G.STEPS * calls
            assert all(shape == (G.BATCH // calls, G.SEQ) for shape, _ in r["seen"])
    # rank order is pod-major: ranks 0, 1 hold data row 0, ranks 2, 3 row 1
    for rank, r in enumerate(ranks["sgd"]):
        half = G.BATCH // 2
        lo = (rank // 2) * half
        for i, (_, local) in enumerate(r["seen"]):
            assert torch.equal(local, data[i]["tokens"][lo:lo + half])


JOPTS = {"sgd": lambda: jsgd.sgd(0.1, momentum=0.9),
         "adamw": lambda: jsgd.adamw(1e-3, eps=1e-3),
         "adagrad": lambda: jsgd.adagrad(1e-2, eps=1e-2)}


@pytest.mark.parametrize("name", ["sgd", "adamw", "adagrad", "microbatch2", "esgd_c2"])
def test_one_process_step_equals_reference(name):
    """The oracle above, on the reference's initial weights, against the
    reference's per-leaf ``make_train_step(..., None)``: losses within
    rtol 1e-4 over 3 steps."""
    _, case = G.CASES[name]
    C = case.get("clients", 1)
    mode = case.get("mode", "mpi_sgd")
    jmodel = jbuild_model(jreduced(jget_config("qwen2-0.5b")))
    jsync = JSync(mode=mode, num_clients=C, esgd_alpha=0.5, esgd_interval=2,
                  fused_update=False, flat_exchange=False)
    jopt = JOPTS[case["opt"]]()
    jstate = jtrain.make_train_state(jmodel, jopt, jsync, jax.random.key(0))
    jstep = jax.jit(jtrain.make_train_step(jmodel, jopt, jsync, None,
                                           microbatch=case.get("microbatch", 1)))
    bridged = params_from_numpy(jax.tree.map(
        np.asarray, jstate["center"] if C > 1 else jstate["params"]))

    tmodel = G.model()
    tsync, topt = G.sync_config(case), G.optimizer(case["opt"])
    tstate = ttrain.make_train_state(tmodel, topt, tsync, device="cpu")
    tstate["params"] = clientize(bridged, C)
    if C > 1:
        tstate["center"] = bridged
    tstep = ttrain.make_train_step(tmodel, topt, tsync, None, device="cpu",
                                   microbatch=case.get("microbatch", 1))
    jl, tl = [], []
    for b in G.batches(C):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
