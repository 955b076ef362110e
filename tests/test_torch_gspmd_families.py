"""The MoE, SSM and hybrid families on the GSPMD path: trained through
``make_train_step(..., mesh)`` and prefilled through
``launch.serve.make_prefill_step(model, mesh)`` on DTensor state over
gloo ranks on the CPU (one process each, ``launch.mesh.spawn_ranks``;
the rank workers are in ``tests/_torch_gspmd_families.py``).

qwen2-moe-a2.7b and mixtral-8x7b (reduced, f32) run on 8 ranks laid out
('data', 'expert', 'tp') = (2, 2, 2), ``make_moe_mesh``'s axes in small:
on a ('data', 'model') mesh whose 'model' axis divides E the reference's
own ``param_specs`` names 'model' twice in the expert weights' specs
(the "expert" and "ff" axes both fall back to it), which neither
``NamedSharding`` nor the port's ``placements`` accepts. mamba2-130m and
zamba2-1.2b run on (data 2, model 2).

Each family's run is held to the port's one-process per-leaf run from the
same moved seed-0 params (``mesh=None``, ``fused_update=False``):

- 3 momentum-SGD steps: losses and every step's metrics within rtol 1e-5,
  and every leaf of the gathered state after the first step and after
  the third within rtol 1e-5 of its value and of the leaf's scale (max
  |value|). zamba2's third-step state is held within 1e-3 of the scale
  instead: its gradients amplify noise — a 1e-7 relative change of the
  initial params moves its state by 1.4e-5 of the scale after one step
  and 3.4e-4 after three, and the one-process run against itself on 1
  and on 3 BLAS threads differs by 1.1e-4 after three (2.6e-7 on the
  losses) — so no other summation order, the mesh's included, can meet
  1e-5 there;
- a prefill: the logits within rtol 1e-5 (and 1e-5 of their scale);
- the MoE dispatch: every rank's (slot, keep) of its own batch rows equal
  the one-process ones, which equal the reference's ``_dispatch_indices``.

The one-process per-leaf step is held to the reference's
``make_train_step(..., None)`` on bridged weights within rtol 1e-4 on the
losses.
"""
import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_families as TF  # noqa: E402
import _torch_gspmd_families as G  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSync  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.sharding.rules import param_specs as jparam_specs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")

RTOL = 1e-5
#: zamba2's third-step state: see the module docstring
STATE_BAND = {"zamba2-1.2b": 1e-3}
MOE = ("qwen2-moe-a2.7b", "mixtral-8x7b")


def _reference_losses(name) -> tuple:
    """3 steps of the reference's per-leaf ``make_train_step(..., None)``
    and of the port's one-process per-leaf step from the same bridged
    weights and batches: (port losses, reference losses)."""
    jm, tm, jp, tp = TF.bridged(name)
    jopt = jsgd.sgd(0.1, momentum=0.9)
    jsync = JSync(mode="mpi_sgd", fused_update=False, flat_exchange=False)
    jstate = jtrain.make_train_state(jm, jopt, jsync, jax.random.key(0))
    jstate["params"] = jax.tree.map(jnp.asarray, jp)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt, jsync, None))
    opt, sync = G.sgd(0.1, 0.9), G.sync_config()
    tstate = ttrain.make_train_state(tm, opt, sync, device="cpu")
    tstate["params"] = tp
    tstep = ttrain.make_train_step(tm, opt, sync, None, device="cpu")
    jl, tl = [], []
    for b in G.batches(tm.cfg.vocab_size):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        tstate, tmet = tstep(tstate, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    return tl, jl


@pytest.fixture(scope="module")
def runs():
    """Both meshes' ranks spawned side by side, and meanwhile the
    one-process runs and the reference's: ({(path, family): [rank
    results]}, {(path, family): one-process result}, {family: (port
    losses, reference losses) on bridged weights})."""
    groups = {}
    for name, mesh in G.MESHES.items():
        groups.setdefault(mesh, []).extend([("train", name), ("prefill", name)])
    ranks, errors = {}, []

    def run(mesh, jobs):
        try:
            res = spawn_ranks(G.rank, mesh[0], mesh[1], backend="gloo",
                              device="cpu", args=(jobs,))
            for job in jobs:
                ranks[job] = [r[job] for r in res]
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(m, j)) for m, j in groups.items()]
    for t in threads:
        t.start()
    torch.set_num_threads(1)
    try:
        one = {job: G.PATHS[job[0]](None, job[1])
               for jobs in groups.values() for job in jobs}
        ref = {name: _reference_losses(name) for name in G.FAMILIES}
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return ranks, one, ref


@pytest.mark.parametrize("name", G.FAMILIES)
def test_train_on_mesh_equals_one_process(runs, name):
    ranks, one, _ = runs
    want = one[("train", name)]
    for r in ranks[("train", name)]:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL)
        for got_m, want_m in zip(r["metrics"], want["metrics"]):
            assert set(got_m) == set(want_m)
            for k in want_m:
                np.testing.assert_allclose(got_m[k], want_m[k], rtol=RTOL, err_msg=k)
        G.close_trees(r["first"], want["first"])
        G.close_trees(r["state"], want["state"], STATE_BAND.get(name, RTOL))


def test_moe_aux_term_is_trained(runs):
    """The MoE's loss carries its load-balance term on the mesh."""
    ranks, _, _ = runs
    for name in MOE:
        for met in ranks[("train", name)][0]["metrics"]:
            assert met["aux"] > 0
            np.testing.assert_allclose(met["loss"], met["xent"] + met["aux"], rtol=1e-6)


@pytest.mark.parametrize("name", G.FAMILIES)
def test_prefill_on_mesh_equals_one_process(runs, name):
    ranks, one, _ = runs
    want = one[("prefill", name)]["logits"]
    assert want.shape == (G.BATCH, G.SEQ, G.model(name).cfg.padded_vocab)
    for r in ranks[("prefill", name)]:
        G.close(r["logits"], want)


@pytest.mark.parametrize("name", MOE)
def test_moe_dispatch_on_mesh_equals_one_process(runs, name):
    """Capacity is per batch row, so each data rank's slots and keeps of
    its own rows are the one-process ones, call by call (2 layers)."""
    ranks, one, _ = runs
    want = one[("prefill", name)]["dispatch"]
    assert len(want) == 2
    for r in ranks[("prefill", name)]:
        assert len(r["dispatch"]) == len(want)
        rows = slice(r["row0"], r["row0"] + G.BATCH // 2)
        for (e, cap, slot, keep), (we, wcap, wslot, wkeep) in zip(r["dispatch"], want):
            assert cap == wcap and e.shape[0] == G.BATCH // 2
            assert torch.equal(e, we[rows])
            assert torch.equal(slot, wslot[rows]) and torch.equal(keep, wkeep[rows])


@pytest.mark.parametrize("name", MOE)
def test_one_process_dispatch_equals_reference(runs, name):
    """The one-process slots and keeps against the reference's
    ``_dispatch_indices`` (vmapped over the rows, as its block does) on
    the same expert assignments; some entries are dropped."""
    _, one, _ = runs
    E = G.model(name).cfg.num_experts
    dropped = 0
    for e, cap, slot, keep in one[("prefill", name)]["dispatch"]:
        js, jk = jax.vmap(lambda fe: jmoe._dispatch_indices(fe, E, cap))(
            jnp.asarray(e.numpy()))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(js))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
        dropped += int((~keep).sum())
    assert dropped > 0


@pytest.mark.parametrize("name", G.FAMILIES)
def test_one_process_step_equals_reference(runs, name):
    """The oracle above, on bridged weights, against the reference's
    per-leaf ``make_train_step(..., None)``: losses within rtol 1e-4 over
    3 steps of the same batches."""
    port, ref = runs[2][name]
    assert len(port) == G.STEPS
    np.testing.assert_allclose(port, ref, rtol=1e-4)


class _Mesh:
    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("name", MOE)
def test_moe_specs_need_the_expert_axis(name):
    """On (data 2, model 2) the reference's and the port's specs give the
    expert weights 'model' twice, which ``placements`` refuses; on
    (data 2, expert 2, tp 2) every spec is placeable."""
    meta = G.model(name).init(device="meta")
    for mesh, ok in ((_Mesh(data=2, model=2), False),
                     (_Mesh(data=2, expert=2, tp=2), True)):
        specs = trules.param_specs(meta, mesh)
        jspecs = jparam_specs(meta, mesh)
        gate = specs["layers"]["moe"]["moe_gate"]
        assert tuple(gate) == tuple(jspecs["layers"]["moe"]["moe_gate"])
        if ok:
            for spec in tree_leaves(specs, trules.is_spec):
                trules.placements(spec, mesh)
        else:
            with pytest.raises(ValueError, match="twice"):
                trules.placements(gate, mesh)


def test_prefill_defaults_to_the_card():
    """``make_prefill_step`` and ``make_train_step(..., mesh)`` default to
    the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    m = G.model("mamba2-130m")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.make_prefill_step(m)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.make_train_step(m, G.sgd(0.1, 0.9), G.sync_config(), None)
