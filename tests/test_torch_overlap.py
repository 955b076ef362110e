"""Backward overlap in the port (``SyncConfig.overlap``) against the
reference's ``tests/test_overlap.py``, on the reduced qwen2-0.5b (f32,
B = 8, S = 16) from bridged weights, on the CPU.

What is held, and how tightly:

  * the schedule geometry (``sizes``, ``chunks``, ``starts``,
    ``leaf_starts``, ``shard_size``) and the staged trees and packed
    staged buffer: equal to the reference's;
  * the staged backward's gradients: ``==`` the port's monolithic
    gradients (the same ops in the same order, the tied embedding's two
    terms summed in the same order), and within f32 rounding of the
    reference's (rtol 1e-4, atol 1e-6, as tests/test_torch_model.py);
  * the overlapped step: ``==`` a trailing same-schedule reference at
    p = 8 for every wire, inside the port; against the non-overlapped
    flat path within the reference's ``_band`` (bitwise at p = 1 and for
    f32 at p = 2); int8 at p = 2 and 4 only (the reference's own
    ``[8-int8]`` row is outside its band and is no oracle);
  * the issue order: each bucket's leg right after its stage's backward,
    and the share of reduce-scatter bytes metered before the embedding
    stage's backward equal to ``cost_model.overlap_fraction``;
  * against the JAX step: per-step loss at rtol 1e-4; the final params at
    rtol 1e-3 / atol 1e-5 over the f32 wire and within the reference's
    quantized-leg band (rtol 1e-2, atol 2e-3) over int8, whose codec is
    discontinuous (tests/test_torch_shard_driver.py says why).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core import comm as jcomm, flatbuf as jflatbuf  # noqa: E402
from repro.core.hierarchy import SyncConfig as JSync  # noqa: E402
from repro.launch import shard_driver as JSD  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import comm as tcomm, cost_model, flatbuf  # noqa: E402
from repro_torch.core import collectives as TC  # noqa: E402
from repro_torch.core.collectives import WireMeter  # noqa: E402
from repro_torch.core.comm import Communicator, CollectivePolicy  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.core.sync_engine import FlatEngine, make_sync_engine  # noqa: E402
from repro_torch.launch import shard_driver as TSD, train as ttrain  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves, tree_map  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")
torch.set_num_threads(2)

AXIS = "ring"
#: the reduced config's schedule and its issue-order share at p = 4
REDUCED_SIZES = (262144, 590848, 590848, 1024)
REDUCED_SHARE_P4 = 0.8185683912119064


@pytest.fixture(scope="module")
def models():
    return (jbuild_model(jreduced(jget_config("qwen2-0.5b"))),
            build_model(reduced(get_config("qwen2-0.5b"))))


@pytest.fixture(scope="module")
def init_np(models):
    return jax.tree.map(np.asarray, models[0].init(jax.random.key(0)))


def _sync(overlap=True, wire=None, buckets=4, **kw):
    pol = dict(method="ring", num_rings=1, wire_dtype=wire, overlap=overlap,
               overlap_buckets=buckets)
    return SyncConfig(mode="mpi_sgd", policy=CollectivePolicy(**pol), **kw)


def _jsync(overlap=True, wire=None, buckets=4):
    return JSync(mode="mpi_sgd", policy=jcomm.CollectivePolicy(
        method="ring", num_rings=1, wire_dtype=wire, overlap=overlap,
        overlap_buckets=buckets))


def _batch_np(B=8, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, 1024, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _tbatch(B=8, S=16, seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch_np(B, S, seed).items()}


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _close_trees(a, b, rtol, atol):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x.float(), y.float(), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# Schedule substrate (reference: test_schedule_tiles_spec_on_the_grid,
# test_schedule_with_p_round_trips, test_schedule_builder_rejects_bad_partitions,
# test_pack_bucket_rejects_mismatched_stage_tree)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_schedule_geometry_equals_reference(models, p):
    jmodel, tmodel = models
    jstages, jsched = jtrain.overlap_schedule(jmodel, _jsync(), p)
    tstages, tsched = ttrain.overlap_schedule(tmodel, _sync(), p)
    assert tstages.num_stages == jstages.num_stages == 4
    for attr in ("sizes", "chunks", "starts", "leaf_starts", "p",
                 "shard_size", "shard_offsets", "num_buckets"):
        assert getattr(tsched, attr) == getattr(jsched, attr), attr
    assert tsched.sizes == REDUCED_SIZES
    assert tsched.spec.size == jsched.spec.size == sum(tsched.sizes)
    assert tsched.spec.offsets == jsched.spec.offsets
    grid = flatbuf.edge_grid()
    for b, (s, n) in enumerate(zip(tsched.starts, tsched.sizes)):
        assert s % grid == 0 and (s + n) % grid == 0
        assert tsched.bucket_padded(b) == jsched.bucket_padded(b) \
            == p * tsched.chunks[b] >= n


def test_full_width_schedule_equals_reference():
    """The full-width staged spec (24 layers, tied embedding): not
    ``grad_spec``'s layout, and the numbers the chip run holds."""
    jmodel = jbuild_model(jget_config("qwen2-0.5b"))
    tmodel = build_model(get_config("qwen2-0.5b"))
    _, jsched = jtrain.overlap_schedule(jmodel, _jsync(), 4)
    _, tsched = ttrain.overlap_schedule(tmodel, _sync(), 4)
    for attr in ("sizes", "chunks", "starts", "leaf_starts", "shard_size"):
        assert getattr(tsched, attr) == getattr(jsched, attr), attr
    assert tsched.spec.size == 494_147_584
    assert tsched.sizes == (136249344, 178948608, 178948608, 1024)
    assert tsched.chunks == (34062336, 44737152, 44737152, 256)
    assert tsched.shard_size == 123_536_896
    assert cost_model.overlap_fraction([n * 4 for n in tsched.sizes], 4) \
        == 0.7242739853201428
    # the embedding leads the staged spec; grad_spec sorts it first too,
    # but final_norm moves from second to last
    gspec = ttrain.grad_spec(tmodel)
    assert gspec.size == tsched.spec.size
    assert gspec.offsets != tsched.spec.offsets


def test_schedule_with_p_round_trips(models):
    _, sched = ttrain.overlap_schedule(models[1], _sync(), 8)
    assert sched.with_p(8) is sched
    assert sched.with_p(1).with_p(8) == sched
    assert sched.with_p(1).shard_size == sched.spec.size
    assert sched.with_p(1).chunks == sched.sizes


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_schedule_builder_rejects_bad_partitions():
    tree = {"a": np.zeros((256,), np.float32), "b": np.zeros((512,), np.float32),
            "c": np.zeros((128,), np.float32)}
    jspec = jflatbuf.spec_for(jax.tree.map(jnp.asarray, tree))
    tspec = flatbuf.spec_for(params_from_numpy(tree))
    for counts in ((1, 1), (2, 0, 1)):
        assert _message(lambda: flatbuf.bucket_schedule(tspec, counts, 2)) \
            == _message(lambda: jflatbuf.bucket_schedule(jspec, counts, 2))
    assert "tile the packed buffer" in _message(
        lambda: flatbuf.bucket_schedule(tspec, (1, 1), 2))
    assert "at least one leaf" in _message(
        lambda: flatbuf.bucket_schedule(tspec, (2, 0, 1), 2))
    # every LANE-aligned leaf boundary is a valid edge
    assert flatbuf.bucket_schedule(tspec, (1, 1, 1), 2).sizes == (256, 512, 256)
    with pytest.raises(ValueError, match=">= 0"):
        flatbuf.align_edge(-1)
    assert flatbuf.align_edge(1) == flatbuf.edge_grid() == 128
    assert flatbuf.align_edge(0) == 0


def test_schedule_rejects_an_edge_off_the_grid():
    """A spec packed at a finer alignment than LANE puts a leaf boundary
    off the LANE × WIRE_BLOCK grid: the reference's message."""
    tree = {"a": np.zeros((64,), np.float32), "b": np.zeros((192,), np.float32)}
    jspec = jflatbuf.make_flatbuf(jax.tree.map(jnp.asarray, tree), align=64)
    tspec = flatbuf.make_flatbuf(params_from_numpy(tree), align=64)
    msg = _message(lambda: flatbuf.bucket_schedule(tspec, (1, 1), 2))
    assert msg == _message(lambda: jflatbuf.bucket_schedule(jspec, (1, 1), 2))
    assert "off the LANE×WIRE_BLOCK grid" in msg


def test_pack_bucket_rejects_mismatched_stage_tree(models):
    _, sched = ttrain.overlap_schedule(models[1], _sync(), 2)
    with pytest.raises(ValueError, match="same overlap_stages split"):
        sched.pack_bucket(0, {"extra": torch.zeros(4), "leaf": torch.zeros(4)})


# --------------------------------------------------------------------------
# Weights across: staged trees and the packed staged buffer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("buckets", [1, 3, 4, 6])
def test_staged_trees_equal_reference(models, init_np, buckets):
    jmodel, tmodel = models
    jstages = jmodel.overlap_stages(buckets)
    tstages = tmodel.overlap_stages(buckets)
    assert tstages.num_stages == jstages.num_stages
    jstaged = jstages.stage(jax.tree.map(jnp.asarray, init_np))
    tparams = params_from_numpy(init_np)
    tstaged = tstages.stage(tparams)
    want, jdef = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, jstaged))
    got = tree_leaves(params_to_numpy(tstaged))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jspec = jflatbuf.spec_for(jstaged)
    tspec = flatbuf.spec_for(tstaged)
    assert tspec.offsets == jspec.offsets and tspec.size == jspec.size
    np.testing.assert_array_equal(tspec.pack(tstaged).numpy(),
                                  np.asarray(jspec.pack(jstaged)))
    _equal_trees(tstages.unstage(tstaged), tparams)


def test_stage_and_unstage_carry_stacked_device_dims(models):
    """The emulated world's stacked params (leading dims ``ndim``) stage
    to each device's staged tree, and unstage back."""
    tmodel = models[1]
    stages = tmodel.overlap_stages(4)
    params = tmodel.init(device="cpu")
    stacked = tree_map(lambda t: torch.stack([t, t * 2, t * 3, t * 4]).reshape(
        (2, 2) + tuple(t.shape)), params)
    staged = stages.stage(stacked, 2)
    for i, j in ((0, 0), (1, 1)):
        _equal_trees(tree_map(lambda t: t[i, j], staged),
                     stages.stage(tree_map(lambda t: t[i, j], stacked)))
    _equal_trees(stages.unstage(staged, 2), stacked)


# --------------------------------------------------------------------------
# The staged backward vs the monolithic gradient
# (reference: test_staged_grads_bit_identical_to_monolithic)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layers,buckets,S", [(2, 4, 16), (3, 4, 16),
                                              (2, 1, 16), (2, 4, 1024)])
def test_staged_grads_bit_identical_to_monolithic(layers, buckets, S):
    """p = 1: ``g_shard`` IS the packed staged gradient. The head's two
    xent chunks at S = 1024 and the tied embedding's lookup + logits
    terms sum in the monolithic order."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), num_layers=layers)
    model = build_model(cfg)
    stages, sched = ttrain.overlap_schedule(model, _sync(buckets=buckets), 1)
    params = model.init(device="cpu", seed=1)
    batch = _tbatch(B=2 if S > 16 else 8, S=S)
    gfn = ttrain.make_overlap_grad_fn(model, stages, sched, tcomm.LOCAL)
    loss_o, met_o, g_shard = gfn(params, batch)
    loss_m, met_m, grads = ttrain.make_grad_fn(model)(params, batch)
    assert float(loss_o) == float(loss_m)
    assert float(met_o["xent"]) == float(met_m["xent"])
    assert torch.equal(g_shard, sched.spec.pack(stages.stage(grads)))


def test_staged_grads_match_reference(models, init_np):
    jmodel, tmodel = models
    jstages, jsched = jtrain.overlap_schedule(jmodel, _jsync(), 1)
    tstages, tsched = ttrain.overlap_schedule(tmodel, _sync(), 1)
    b = _batch_np()
    jloss, _, jg = jax.jit(jtrain.make_overlap_grad_fn(
        jmodel, jstages, jsched, jcomm.LOCAL))(
            jax.tree.map(jnp.asarray, init_np), jax.tree.map(jnp.asarray, b))
    tloss, _, tg = ttrain.make_overlap_grad_fn(
        tmodel, tstages, tsched, tcomm.LOCAL)(params_from_numpy(init_np), _tbatch())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------
# Collectives on identical inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_bucket_legs_equal_reference(wire):
    """One bucket's leg, the trailing scheduled allgather and the shard
    selection at p = 4 on the same stacked inputs: ``==`` the
    reference's emulated (vmap) legs."""
    from repro.core import collectives as JC

    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 700)).astype(np.float32),
            "b": rng.standard_normal((2048,)).astype(np.float32)}
    jspec = jflatbuf.spec_for(jax.tree.map(jnp.asarray, tree))
    tspec = flatbuf.spec_for(params_from_numpy(tree))
    p = 4
    jsched = jflatbuf.bucket_schedule(jspec, (1, 1), p)
    tsched = flatbuf.bucket_schedule(tspec, (1, 1), p)
    assert tsched.chunks == jsched.chunks
    segs = [rng.standard_normal((p, n)).astype(np.float32) for n in tsched.sizes]
    jc = jcomm.Communicator.world((AXIS,), (p,), method="ring", wire_dtype=wire)
    meter = WireMeter()
    tc = Communicator.world((AXIS,), (p,), policy=CollectivePolicy(
        method="ring", wire_dtype=wire), meter=meter)
    for b, seg in enumerate(segs):
        want = JC.emulate(lambda x, ax, b=b: jc.reduce_scatter_bucket(x, jsched, b),
                          jnp.asarray(seg))
        got = tc.reduce_scatter_bucket(torch.from_numpy(seg), tsched, b)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got1 = TC.sched_reduce_scatter_bucket(torch.from_numpy(seg), 0, tsched, b,
                                              wire_dtype=wire)
        np.testing.assert_array_equal(got1.numpy(), np.asarray(want))
    shard = rng.standard_normal((p, tsched.shard_size)).astype(np.float32)
    want = JC.emulate(lambda x, ax: jc.allgather_sched(x, jsched), jnp.asarray(shard))
    meter.reset()
    got = tc.allgather_sched(torch.from_numpy(shard), tsched)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert meter.bytes == cost_model.param_leg_bytes(p * tsched.shard_size * 4,
                                                     p, wire)
    full = rng.standard_normal((p, tspec.size)).astype(np.float32)
    want = JC.emulate(lambda x, ax: jc.shard_select_sched(x, jsched), jnp.asarray(full))
    got = tc.shard_select_sched(torch.from_numpy(full), tsched)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# The overlapped step (reference: test_overlap_step_matches_trailing_
# reference_at_p8, test_overlap_step_matrix_vs_flat_path,
# test_uneven_last_bucket, test_single_bucket_degenerate,
# test_two_axis_pod_data_driver)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_overlap_step_matches_trailing_reference_at_p8(models, wire):
    """p = 8: ``==`` a step that computes the MONOLITHIC gradient of every
    device and then runs the SAME schedule's bucket legs after backward,
    isolating the staged backward from ring fold order."""
    tmodel = models[1]
    p = 8
    opt = tsgd.adamw(3e-3, eps=1e-5)
    stages, sched = ttrain.overlap_schedule(tmodel, _sync(wire=wire), p)
    comm = Communicator.world((AXIS,), (p,), policy=CollectivePolicy(
        method="ring", wire_dtype=wire))
    params = TSD._stack(tmodel.init(device="cpu"), p)
    opt0 = TSD._stack(tsgd.optstate_sched_init(opt.hyper, sched), p)
    batch = TSD.shard_batch(_tbatch(), p)

    def finish(g_shard):
        new_staged, new_opt = tsgd.overlap_update(
            sched, g_shard, stages.stage(params, 1), opt0, hyper=opt.hyper,
            comm=comm)
        return stages.unstage(new_staged, 1), new_opt

    loss_o, _, g_o = ttrain.make_overlap_grad_fn(tmodel, stages, sched, comm)(
        params, batch)
    loss_t, _, grads = ttrain.stacked_grads(ttrain.make_grad_fn(tmodel), params,
                                            batch)
    gstaged = stages.stage(grads, 1)
    g_t = torch.cat([comm.reduce_scatter_bucket(
        torch.stack([sched.pack_bucket(b, tree_map(lambda t: t[d], gstaged[b]))
                     for d in range(p)]), sched, b)
        for b in range(sched.num_buckets)], -1)
    assert torch.equal(loss_o, loss_t)
    assert torch.equal(g_o, g_t)
    _equal_trees(finish(g_o), finish(g_t))


def _band(p, wire):
    """The reference's band per (p, wire) cell against the flat path
    (``tests/test_overlap.py``): bitwise where the arithmetic forces it."""
    if p == 1 or (p == 2 and wire is None):
        return None
    if wire is None:
        return dict(loss_rel=1e-6, rtol=1e-5, atol=1e-6)
    return dict(loss_rel=2e-3, rtol=1e-2, atol=2e-3)


def _run_pair(model, p, wire, *, buckets=4, steps=2, B=8, meters=False):
    opt = tsgd.sgd(0.1, 0.9)
    so = TSD.make_driver_state(model, opt, _sync(wire=wire, buckets=buckets), p,
                               device="cpu")
    sm = TSD.make_driver_state(model, opt, _sync(False, wire=wire), p,
                               device="cpu")
    sm["params"] = tree_map(torch.clone, so["params"])
    mo, mm = WireMeter(), WireMeter()
    step_o = TSD.make_emulated_step(model, opt, _sync(wire=wire, buckets=buckets),
                                    p, meter=mo)
    step_m = TSD.make_emulated_step(model, opt, _sync(False, wire=wire), p,
                                    meter=mm)
    batch = TSD.shard_batch(_tbatch(B=B), p)
    out = []
    for _ in range(steps):
        mo.reset()
        mm.reset()
        so, m_o = step_o(so, batch)
        sm, m_m = step_m(sm, batch)
        out.append((float(m_o["loss"]), float(m_m["loss"])))
    return out, so, sm, (mo.bytes, mm.bytes)


MATRIX = ([(p, w) for p in (1, 2, 8) for w in (None, "bf16")]
          + [(2, "int8"), (4, "int8")])


@pytest.mark.parametrize("p,wire", MATRIX, ids=lambda v: str(v))
def test_overlap_step_vs_flat_path(models, p, wire):
    band = _band(p, wire)
    losses, so, sm, _ = _run_pair(models[1], p, wire)
    for lo, lm in losses:
        if band is None:
            assert lo == lm
        else:
            assert lo == pytest.approx(lm, rel=band["loss_rel"])
    if band is None:
        _equal_trees(so["params"], sm["params"])
    else:
        _close_trees(so["params"], sm["params"], band["rtol"], band["atol"])


def test_uneven_last_bucket():
    """3 layers with 4 buckets: layer slices of 2 and 1 — the schedule
    tiles anyway (as the reference's) and the step stays ``==`` the
    monolithic path at p = 2."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), num_layers=3)
    m3 = build_model(cfg)
    stages, sched = ttrain.overlap_schedule(m3, _sync(), 2)
    jcfg = dataclasses.replace(jreduced(jget_config("qwen2-0.5b")), num_layers=3)
    _, jsched = jtrain.overlap_schedule(jbuild_model(jcfg), _jsync(), 2)
    assert stages.num_stages == 4
    assert sched.sizes == jsched.sizes and sched.sizes[1] != sched.sizes[2]
    assert sum(sched.sizes) == sched.spec.size
    losses, so, sm, _ = _run_pair(m3, 2, None, steps=1, B=4)
    assert losses[0][0] == losses[0][1]
    _equal_trees(so["params"], sm["params"])


def test_single_bucket_degenerate(models):
    """overlap_buckets=1: the whole loss is one stage and the one leg
    trails backward — zero overlap, the step ``==`` the flat path."""
    stages, sched = ttrain.overlap_schedule(models[1], _sync(buckets=1), 2)
    assert stages.num_stages == 1 and sched.num_buckets == 1
    assert cost_model.overlap_fraction([sched.sizes[0] * 4], 2) == 0.0
    losses, so, sm, _ = _run_pair(models[1], 2, None, buckets=1, steps=1, B=4)
    assert losses[0][0] == losses[0][1]
    _equal_trees(so["params"], sm["params"])


def test_two_axis_pod_data_driver(models):
    """(2, 2) pod×data: nested per-axis bucket legs, within fp
    reassociation of the 2-axis flat path; the device state carries the
    schedule geometry at total p = 4."""
    losses, so, sm, (bo, bm) = _run_pair(models[1], (2, 2), None)
    for lo, lm in losses:
        assert lo == pytest.approx(lm, rel=1e-6)
    _close_trees(so["params"], sm["params"], 1e-5, 1e-6)
    _, sched4 = ttrain.overlap_schedule(models[1], _sync(), 4)
    assert tuple(so["opt"].shape) == (4, sched4.shard_size)
    assert bo == bm    # no per-bucket padding at this geometry


# --------------------------------------------------------------------------
# Wire bytes and the issue order
# (reference: test_traced_program_interleaves_ppermute_with_backward)
# --------------------------------------------------------------------------

class _IssueLog:
    """The overlapped step's issue order: each stage backward (with the
    bytes metered before it) and each bucket leg (with its bytes)."""

    def __init__(self, meter, monkeypatch):
        self.events = []
        bwd, rs = ttrain.stage_backward, Communicator.reduce_scatter_bucket

        def logged_bwd(s, *args):
            self.events.append(("bwd", s, meter.bytes))
            return bwd(s, *args)

        def logged_rs(comm, seg, schedule, b):
            before = meter.bytes
            out = rs(comm, seg, schedule, b)
            self.events.append(("rs", b, meter.bytes - before))
            return out

        monkeypatch.setattr(ttrain, "stage_backward", logged_bwd)
        monkeypatch.setattr(Communicator, "reduce_scatter_bucket", logged_rs)


@pytest.mark.parametrize("p,wire", [(4, None), ((2, 2), None), (4, "int8")],
                         ids=lambda v: str(v))
def test_issue_order_and_wire_bytes(models, monkeypatch, p, wire):
    tmodel = models[1]
    sync = _sync(wire=wire)
    pt = 4
    _, sched = ttrain.overlap_schedule(tmodel, sync, pt)
    opt = tsgd.sgd(0.1, 0.9)
    meter = WireMeter()
    state = TSD.make_driver_state(tmodel, opt, sync, p, device="cpu")
    step = TSD.make_emulated_step(tmodel, opt, sync, p, meter=meter)
    log = _IssueLog(meter, monkeypatch)
    step(state, TSD.shard_batch(_tbatch(), p))
    S = sched.num_buckets
    # one backward per stage over all devices, head first, each bucket's
    # leg right after its stage's backward
    assert [e[:2] for e in log.events] == [
        ev for s in range(S - 1, -1, -1) for ev in (("bwd", s), ("rs", s))]
    legs = {e[1]: e[2] for e in log.events if e[0] == "rs"}
    for b in range(S):
        assert legs[b] == cost_model.grad_leg_bytes(sched.bucket_padded(b) * 4,
                                                    pt, wire)
    rs_total = sum(legs.values())
    before = next(e[2] for e in log.events if e == ("bwd", 0, e[2]))
    after = rs_total - before
    assert after == legs[0]
    share = 1.0 - after / rs_total
    assert share == cost_model.overlap_fraction([n * 4 for n in sched.sizes], pt)
    if wire is None:
        assert share == REDUCED_SHARE_P4
    # the step's bytes: the bucket legs plus the one trailing allgather
    assert meter.bytes == rs_total + cost_model.param_leg_bytes(
        pt * sched.shard_size * 4, pt, wire)


# --------------------------------------------------------------------------
# Guard rails (reference: test_sync_config_overlap_guards through
# test_train_state_overlap_opt_geometry)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(policy=None, allreduce_method="psum"), dict(fused_update=False),
    dict(mode="mpi_esgd"), dict(overlap_buckets=0),
    dict(bucket_bytes=1 << 20), dict(num_rings=2), dict(fsdp=True)],
    ids=["psum", "unfused", "esgd", "buckets0", "bucket_bytes", "rings2", "fsdp"])
def test_sync_config_overlap_guards(kw):
    """Each guard raises the reference's message, word for word."""
    base = dict(mode="mpi_sgd", allreduce_method="ring", num_rings=1,
                overlap=True, overlap_buckets=4)
    base.update({k: v for k, v in kw.items() if k != "policy"})

    def verdict(cls):
        try:
            cls(**base).validate()
        except ValueError as e:
            return str(e)
        return None

    got, want = verdict(SyncConfig), verdict(JSync)
    assert want is not None and got == want
    _sync().validate()    # a clean overlap config passes


def test_overlap_update_rejects_knobs_and_wrong_p(models):
    tmodel = models[1]
    stages, sched = ttrain.overlap_schedule(tmodel, _sync(), 1)
    staged = stages.stage(tmodel.init(device="cpu"))
    hyper = tsgd.sgd(0.1, 0.9).hyper
    g = torch.zeros(sched.shard_size)
    state = tsgd.optstate_sched_init(hyper, sched)
    with pytest.raises(ValueError, match="communicator"):
        tsgd.overlap_update(sched, g, staged, state, hyper=hyper, wire_dtype="bf16")
    with pytest.raises(ValueError, match="communicator"):
        tsgd.overlap_update(sched, g, staged, state, hyper=hyper, num_rings=2)
    with pytest.raises(ValueError, match="gradient group"):
        tsgd.overlap_update(sched, g, staged, state, hyper=hyper,
                            comm=Communicator.world((AXIS,), (2,)))
    new_staged, _ = tsgd.overlap_update(sched, g, staged, state, hyper=hyper)
    assert tree_flatten(new_staged)[1] == tree_flatten(staged)[1]
    _equal_trees(new_staged, staged)     # zero grad, zero momentum


def test_make_train_step_overlap_guards(models):
    tmodel = models[1]
    opt = tsgd.sgd(0.1, 0.9)
    with pytest.raises(ValueError, match="microbatch"):
        ttrain.make_train_step(tmodel, opt, _sync(), microbatch=2, device="cpu")
    with pytest.raises(ValueError, match="microbatch"):
        TSD.make_emulated_step(tmodel, opt, _sync(), 2, microbatch=2)
    bare = dataclasses.replace(tmodel, overlap_stages=None)
    with pytest.raises(ValueError, match="overlap_stages"):
        ttrain.overlap_schedule(bare, _sync(), 1)
    spec = ttrain.overlap_schedule(tmodel, _sync(), 1)[1].spec
    with pytest.raises(ValueError, match="overlap_schedule"):
        make_sync_engine(opt, _sync(), spec=spec, schedule=None)
    with pytest.raises(ValueError, match="fused path only"):
        make_sync_engine(tsgd.sgd(0.1), _sync(), spec=spec)
    # state of another geometry is refused before the step runs
    state = ttrain.make_train_state(tmodel, opt, _sync(), device="cpu")
    step = ttrain.make_train_step(tmodel, opt, _sync(), device="cpu")
    with pytest.raises(ValueError, match="elements per stream"):
        step(dict(state, opt=state["opt"][:-1024]), _tbatch())
    with pytest.raises(ValueError, match="flat state buffer"):
        step(dict(state, opt={"m": state["opt"]}), _tbatch())


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", dict(lr=0.1, momentum=0.9)), ("sgd", dict(lr=0.1)),
    ("adamw", dict(lr=3e-3)), ("adagrad", dict(lr=1e-2))])
def test_fused_path_active_equals_reference(opt_name, kw):
    """Whether the fused update (the only one overlap rides) engages."""
    for fused in (True, False):
        for mode in ("mpi_sgd", "mpi_esgd"):
            j = jtrain.fused_path_active(
                jsgd.get_optimizer(opt_name, **kw),
                JSync(mode=mode, fused_update=fused))
            t = ttrain.fused_path_active(
                tsgd.get_optimizer(opt_name, **kw),
                SyncConfig(mode=mode, fused_update=fused))
            assert t == j, (opt_name, kw, fused, mode)


def test_drive_rejects_faults_with_overlap(models):
    with pytest.raises(ValueError, match="elastic re-layout"):
        TSD.drive(models[1], tsgd.sgd(0.1, 0.9), _sync(), [_tbatch(B=4)], p=2,
                  device="cpu", faults="kill@1:unit=1")


def test_train_state_overlap_opt_geometry(models, init_np):
    """make_train_state with overlap carries the LOCAL (p=1) schedule state
    (one full-length stream laid out bucket-major), as the reference's."""
    jmodel, tmodel = models
    for name, hyper in (("sgd", dict(lr=0.1, momentum=0.9)),
                        ("adamw", dict(lr=3e-3))):
        s = ttrain.make_train_state(tmodel, tsgd.get_optimizer(name, **hyper),
                                    _sync(), device="cpu")
        j = jtrain.make_train_state(jmodel, jsgd.get_optimizer(name, **hyper),
                                    _jsync(), jax.random.key(0), abstract=True)
        assert [tuple(a.shape) for a in tree_leaves(s["opt"])] == \
            [tuple(a.shape) for a in jax.tree.leaves(j["opt"])]
    _, sched = ttrain.overlap_schedule(tmodel, _sync(), 1)
    engine = make_sync_engine(tsgd.sgd(0.1, 0.9), _sync(),
                              spec=ttrain.grad_spec(tmodel), schedule=sched)
    assert isinstance(engine, FlatEngine) and engine.schedule is sched
    assert tuple(s["opt"]["mv"].shape) == (2, sched.shard_size)
    assert sched.shard_size == sched.spec.size


# --------------------------------------------------------------------------
# The port's overlapped step against the JAX step
# --------------------------------------------------------------------------

def _jax_driver(jmodel, p, wire, steps):
    jopt = jsgd.sgd(0.1, momentum=0.9)
    jst = JSD.make_driver_state(jmodel, jopt, _jsync(wire=wire), p, jax.random.key(1))
    step = jax.jit(JSD.make_emulated_step(jmodel, jopt, _jsync(wire=wire), p))
    init = jax.tree.map(np.asarray, jst["params"])
    losses = []
    for i in range(steps):
        b = JSD.shard_batch(jax.tree.map(jnp.asarray, _batch_np(seed=i)), p)
        jst, met = step(jst, b)
        losses.append(float(met["loss"]))
    return init, np.array(losses), jst


@pytest.mark.parametrize("p,wire", [(4, None), (2, "int8"), ((2, 2), None)],
                         ids=lambda v: str(v))
def test_driver_matches_jax(models, p, wire):
    jmodel, tmodel = models
    steps = 2
    init, jl, jst = _jax_driver(jmodel, p, wire, steps)
    opt = tsgd.sgd(0.1, 0.9)
    tst = TSD.make_driver_state(tmodel, opt, _sync(wire=wire), p, device="cpu")
    tst["params"] = params_from_numpy(init)
    step = TSD.make_emulated_step(tmodel, opt, _sync(wire=wire), p)
    tl = []
    for i in range(steps):
        tst, met = step(tst, TSD.shard_batch(_tbatch(seed=i), p))
        tl.append(float(met["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tuple(tst["opt"].shape) == tuple(jst["opt"].shape)
    tol = dict(rtol=1e-3, atol=1e-5) if wire is None else dict(rtol=1e-2, atol=2e-3)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jst["params"]))
    for g, w in zip(tree_leaves(params_to_numpy(tst["params"])), want):
        np.testing.assert_allclose(g, w, **tol)


def test_train_step_matches_jax(models, init_np):
    """make_train_step with overlap at p = 1 (AdamW at eps 1e-5, as
    tests/test_torch_train.py holds final params), 2 steps."""
    jmodel, tmodel = models
    jopt = jsgd.adamw(3e-3, eps=1e-5)
    topt = tsgd.adamw(3e-3, eps=1e-5)
    jst = jtrain.make_train_state(jmodel, jopt, _jsync(), jax.random.key(0))
    jstep = jax.jit(jtrain.make_train_step(jmodel, jopt, _jsync(), None))
    tst = ttrain.make_train_state(tmodel, topt, _sync(), device="cpu")
    tst["params"] = params_from_numpy(init_np)
    tstep = ttrain.make_train_step(tmodel, topt, _sync(), device="cpu")
    jl, tl = [], []
    for i in range(2):
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, _batch_np(seed=i)))
        tst, tm = tstep(tst, _tbatch(seed=i))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jst["params"]))
    for g, w in zip(tree_leaves(params_to_numpy(tst["params"])), want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tst["opt"]["mv"].numpy(), np.asarray(jst["opt"]["mv"]),
                               rtol=1e-3, atol=1e-6)
