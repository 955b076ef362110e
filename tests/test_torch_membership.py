"""The port's elastic membership (``repro_torch.core.membership``,
``Communicator.resized``, the membership half of ``core/cost_model``, the
KVStore barrier under a ``Membership``) and the emulated shard driver's
``drive(faults=...)`` against the reference's.

Tolerances: epochs, ranks, re-split sizes, the re-sharded optimizer state
and every byte and time of the accounting exactly equal (the state is
moved, never computed); ``moved_bytes`` equal to
``cost_model.reshard_leg_bytes`` / ``join_reshard_bytes``. ``drive``
under ``kill@1:unit=3;restart@3:unit=3`` at p = 4 on the reduced
qwen2-0.5b: the membership entries equal, the per-step losses rtol 1e-4
and the final stacked state rtol 1e-3 / atol 1e-5, as
``tests/test_torch_shard_driver.py`` holds the clean driver.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as jcost, flatbuf as jflat  # noqa: E402
from repro.core.comm import Communicator as JComm  # noqa: E402
from repro.core.kvstore import KVStore as JKV  # noqa: E402
from repro.core.membership import Membership as JMembership  # noqa: E402
from repro.core.membership import reshard_optstate as jreshard  # noqa: E402
from repro.launch import shard_driver as JSD  # noqa: E402
from repro_torch.core import cost_model as tcost, flatbuf as tflat  # noqa: E402
from repro_torch.core.comm import CollectivePolicy, Communicator as TComm  # noqa: E402
from repro_torch.core.hierarchy import SyncConfig  # noqa: E402
from repro_torch.core.kvstore import KVStore as TKV  # noqa: E402
from repro_torch.core.membership import Membership, reshard_optstate  # noqa: E402
from repro_torch.launch import shard_driver as TSD  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_shard_driver import _batch, _bridge, _close, _syncs  # noqa: E402

jsgd = importlib.import_module("repro.optim.sgd")
tsgd = importlib.import_module("repro_torch.optim.sgd")
torch.set_num_threads(2)

PARAMS = {"w": np.zeros((13, 5), np.float32), "b": np.zeros((7,), np.float32),
          "s": np.zeros((3, 3), np.float32)}


def _specs():
    return (jflat.spec_for({k: jnp.asarray(v) for k, v in PARAMS.items()}),
            tflat.spec_for({k: torch.from_numpy(v) for k, v in PARAMS.items()}))


# -- membership epochs and the re-split -----------------------------------------

def test_epochs_ranks_and_resplit_equal_reference():
    jm = JMembership(4, JComm.world(("client",), (4,)))
    tm = Membership(4, TComm.world(("client",), (4,)))
    for op, member in (("fail", 2), ("leave", 0), ("join", 2), ("join", 7),
                       ("fail", 1)):
        je, te = getattr(jm, op)(member), getattr(tm, op)(member)
        assert (te.epoch, te.live, te.kind, te.member) == \
            (je.epoch, je.live, je.kind, je.member)
        assert tm.comm.sizes == jm.comm.sizes and tm.comm.axes == jm.comm.axes
        assert tm.comm.policy.to_dict() == jm.comm.policy.to_dict()
        assert (tm.live, tm.live_count, tm.epoch) == (jm.live, jm.live_count, jm.epoch)
        assert [tm.rank_of(u) for u in tm.live] == [jm.rank_of(u) for u in jm.live]
    assert [e.kind for e in tm.history] == [e.kind for e in jm.history]
    m = Membership(2)
    with pytest.raises(ValueError, match="already live"):
        m.join(1)
    m.fail(0)
    with pytest.raises(ValueError, match="last live member"):
        m.fail(1)
    with pytest.raises(ValueError, match="not live"):
        m.leave(0)
    with pytest.raises(KeyError):
        m.rank_of(0)
    with pytest.raises(ValueError, match="at least one"):
        Membership([])


def test_resized_equals_reference():
    pol = CollectivePolicy(method="ring", num_rings=2, wire_dtype="int8")
    jw = JComm.world(("a", "b"), (2, 3))
    tw = TComm.world(("a", "b"), (2, 3), policy=pol)
    assert tw.resized(4, axis="b").sizes == jw.resized(4, axis="b").sizes == (2, 4)
    assert tw.resized(4, axis="b").policy == pol
    one = TComm.world(("x",), (3,))
    assert one.resized(5).sizes == (5,) and one.resized(5).axes == ("x",)
    for bad in (lambda w: w.resized(4), lambda w: w.resized(4, axis="c"),
                lambda w: w.local().resized(1), lambda w: w.resized(0, axis="a")):
        for w in (jw, tw):
            with pytest.raises(ValueError):
                bad(w)


# -- optimizer-state re-shard ----------------------------------------------------

def _stacked(spec, p, nr, seed=0, lead=()):
    shard = tflat.shard_size(spec, p, nr)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p,) + lead + (shard,)) + 3.0).astype(np.float32)


@pytest.mark.parametrize("p_old,p_new,survivors", [
    (2, 1, None), (2, 2, None), (8, 7, None), (8, 4, None), (2, 3, None),
    (8, 8, None), (4, 3, (0, 1, 3)), (4, 4, (3, 0, 2)), (3, 5, (0, 1, 2))])
@pytest.mark.parametrize("nr", [1, 2])
def test_reshard_optstate_equals_reference(p_old, p_new, survivors, nr):
    jspec, tspec = _specs()
    stacked = _stacked(tspec, p_old, nr)
    kw = dict(survivors=survivors, num_rings=nr)
    jnew, jinfo = jreshard(jsgd.sgd(0.1, momentum=0.9).hyper, jspec,
                           jnp.asarray(stacked), p_old, p_new, **kw)
    tnew, tinfo = reshard_optstate(tsgd.sgd(0.1, 0.9).hyper, tspec,
                                   torch.from_numpy(stacked), p_old, p_new, **kw)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    assert tinfo == jinfo
    s = len(tinfo["survivors"])
    assert tinfo["moved_bytes"] == tcost.reshard_leg_bytes(
        tinfo["state_nbytes"], p_old, survivors=s) == jcost.reshard_leg_bytes(
        jinfo["state_nbytes"], p_old, survivors=s)


def test_reshard_adamw_and_bf16_streams_equal_reference():
    jspec, tspec = _specs()
    mv = _stacked(tspec, 4, 1, seed=1, lead=(2,))
    t = np.asarray([5, 6, 7, 8], np.int32)
    for survivors, p_new in (((0, 1, 2, 3), 5), ((0, 2, 3), 3), ((1,), 2)):
        jnew, jinfo = jreshard(jsgd.adamw(1e-3).hyper, jspec,
                               {"mv": jnp.asarray(mv), "t": jnp.asarray(t)},
                               4, p_new, survivors=survivors)
        tnew, tinfo = reshard_optstate(tsgd.adamw(1e-3).hyper, tspec,
                                       {"mv": torch.from_numpy(mv),
                                        "t": torch.from_numpy(t)},
                                       4, p_new, survivors=survivors)
        np.testing.assert_array_equal(tnew["mv"].numpy(), np.asarray(jnew["mv"]))
        np.testing.assert_array_equal(tnew["t"].numpy(), np.asarray(jnew["t"]))
        assert tinfo == jinfo
    stacked = _stacked(tspec, 2, 2, seed=2)
    jnew, _ = jreshard(jsgd.adagrad(0.1).hyper, jspec, jnp.asarray(stacked), 2, 3,
                       num_rings=2, state_dtypes=jnp.bfloat16)
    tnew, _ = reshard_optstate(tsgd.adagrad(0.1).hyper, tspec, torch.from_numpy(stacked),
                               2, 3, num_rings=2, state_dtypes=torch.bfloat16)
    assert tnew.dtype == torch.bfloat16
    np.testing.assert_array_equal(tnew.float().numpy(),
                                  np.asarray(jnew.astype(jnp.float32)))


def test_reshard_validates_inputs_as_reference():
    _, tspec = _specs()
    stacked = torch.from_numpy(_stacked(tspec, 2, 1))
    hyper = tsgd.sgd(0.1, 0.9).hyper
    for kw, match in ((dict(p_new=2, survivors=(0, 0)), "duplicate"),
                      (dict(p_new=2, survivors=(3,)), "outside"),
                      (dict(p_new=1, survivors=(0, 1)), "cannot fit")):
        with pytest.raises(ValueError, match=match):
            reshard_optstate(hyper, tspec, stacked, 2, **kw)
    with pytest.raises(ValueError, match="shape"):
        reshard_optstate(hyper, tspec, stacked[:, :-1], 2, 1)
    with pytest.raises(ValueError, match="flat families"):
        reshard_optstate({"name": "lbfgs"}, tspec, stacked, 2, 1)


def test_membership_cost_model_equals_reference():
    jnet, tnet = jcost.testbed(), tcost.testbed()
    for nbytes, p_old, p_new, s, wire in ((1e6, 4, 3, 3, None), (5779456, 4, 3, None, "int8"),
                                          (3e7, 8, 1, 1, "bf16"), (1e6, 1, 2, None, None),
                                          (7e5, 3, 4, 3, "f32")):
        assert tcost.reshard_leg_bytes(nbytes, p_old, s, wire) == \
            jcost.reshard_leg_bytes(nbytes, p_old, s, wire)
        assert tcost.join_reshard_bytes(nbytes, p_old, s, wire) == \
            jcost.join_reshard_bytes(nbytes, p_old, s, wire)
        assert tcost.resplit_time(p_new, tnet) == jcost.resplit_time(p_new, jnet)
        assert tcost.reconfig_time(nbytes, p_old, p_new, tnet, s, wire) == \
            jcost.reconfig_time(nbytes, p_old, p_new, jnet, s, wire)
        for restore, delay, state in ((0.0, 0.1, 0.0), (4e6, 0.0, nbytes), (1e3, 2.5, 0.0)):
            assert tcost.recovery_time(restore, delay, p_old, p_new, tnet,
                                       state_nbytes=state, survivors=s,
                                       wire_dtype=wire) == \
                jcost.recovery_time(restore, delay, p_old, p_new, jnet,
                                    state_nbytes=state, survivors=s, wire_dtype=wire)
    assert tcost.restore_leg_bytes(12345) == jcost.restore_leg_bytes(12345) == 49380


@pytest.mark.parametrize("clients", [2, 4])
def test_barrier_tracks_the_live_count_as_reference(clients):
    """An attached Membership shrinks (and regrows) the sync barrier; a
    barrier of the survivors releases with the survivors' pushes."""
    stores = []
    for KV, M, wrap in ((JKV, JMembership, jnp.asarray), (TKV, Membership, torch.tensor)):
        kv = KV.create("sync_mpi", num_workers=clients * 2, num_clients=clients)
        kv.init("g", wrap(np.zeros(3, np.float32)))
        m = M(clients)
        kv.attach_membership(m)
        counts = [kv.expected_pushers]
        m.fail(clients - 1)
        counts.append(kv.expected_pushers)
        for c in range(clients - 1):
            kv.push("g", wrap(np.full(3, c + 1.0, np.float32)))
        counts.append(kv.last_barrier_count)
        m.join(clients - 1)
        counts.append(kv.expected_pushers)
        stores.append((counts, np.asarray(kv.pull("g")[0])))
    (jc, jv), (tc, tv) = stores
    assert tc == jc == [clients, clients - 1, clients - 1, clients]
    np.testing.assert_array_equal(tv, jv)


@pytest.fixture(scope="module")
def models():
    from repro.configs.base import get_config as jget_config, reduced as jreduced
    from repro.models.model import build_model as jbuild_model
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import build_model

    return (jbuild_model(jreduced(jget_config("qwen2-0.5b"))),
            build_model(reduced(get_config("qwen2-0.5b"))))


# -- drive(faults=...): kills and joins on the 1-axis layout ------------------------

DRIVE_FAULTS = "kill@1:unit=3;restart@3:unit=3"


def _drive_both(models, mode, faults, steps=4, p=4):
    """``drive`` of both frameworks under one schedule, from the same
    weights: the port's ``make_driver_state`` is wrapped to start from the
    reference's params (and centers)."""
    jmodel, tmodel = models
    jsync, tsync = _syncs(mode, p, None)
    jbatch = _batch(0, B=12)                  # divides over 4 and 3 devices
    jst0 = JSD.make_driver_state(jmodel, jsgd.sgd(0.1, momentum=0.9), jsync, p,
                                 jax.random.key(1))
    jstate, jh = JSD.drive(jmodel, jsgd.sgd(0.1, momentum=0.9), jsync,
                           [{k: jnp.asarray(v) for k, v in jbatch.items()}] * steps,
                           p=p, rng=jax.random.key(1), log_every=1, faults=faults)
    made = TSD.make_driver_state

    def bridged(*args, **kw):
        return _bridge(jst0, made(*args, **kw))

    TSD.make_driver_state = bridged
    try:
        tstate, th = TSD.drive(tmodel, tsgd.sgd(0.1, 0.9), tsync,
                               [{k: torch.from_numpy(v) for k, v in jbatch.items()}] * steps,
                               p=p, device="cpu", log_every=1, faults=faults)
    finally:
        TSD.make_driver_state = made
    return jstate, jh, tstate, th


@pytest.mark.parametrize("mode", ["mpi_sgd", "mpi_esgd"])
def test_drive_kill_and_join_match_reference(models, mode):
    """``kill@1:unit=3;restart@3:unit=3`` at p = 4: the stacked rows go
    4 -> 3 -> 4, the reconfigure and join entries equal the reference's
    (survivors, moved bytes, the cost model's times), the per-step losses
    within rtol 1e-4 and the final stacked state within the f32
    tolerances of ``test_driver_matches_reference``."""
    from repro_torch.core import cost_model

    jstate, jh, tstate, th = _drive_both(models, mode, DRIVE_FAULTS)
    jev = [e for e in jh if "event" in e]
    tev = [e for e in th if "event" in e]
    assert [e["event"] for e in tev] == ["reconfigure", "join"]
    assert tev == jev
    kill, join = tev
    assert (kill["p_old"], kill["p_new"], join["p_new"]) == (4, 3, 4)
    if mode == "mpi_sgd":
        assert kill["moved_bytes"] == cost_model.reshard_leg_bytes(
            kill["state_nbytes"], 4, survivors=3)
        assert join["moved_bytes"] == cost_model.join_reshard_bytes(
            join["state_nbytes"], 3)
    np.testing.assert_allclose([e["loss"] for e in th if "loss" in e],
                               [e["loss"] for e in jh if "loss" in e], rtol=1e-4)
    assert sorted(tstate) == sorted(jstate)
    for key in jstate:
        assert [tuple(a.shape) for a in tree_leaves(tstate[key])] == \
            [tuple(a.shape) for a in jax.tree.leaves(jstate[key])], key
        if key != "step":
            _close(jstate[key], tstate[key], rtol=1e-3, atol=1e-5, what=key)
    np.testing.assert_array_equal(tstate["step"].numpy(), np.asarray(jstate["step"]))


def test_drive_fault_refusals_equal_reference(models):
    """The reference's own refusals stay refusals, with its messages:
    timing faults on the driver, kills or restarts under the 2-axis
    layout, faults with overlap, faults with a mesh."""
    jmodel, tmodel = models
    for faults, p, match in (("straggle@0:unit=0", 2, "need a clock"),
                             ("kill@1:unit=0", (2, 2), "2-axis"),
                             ("corrupt@0:unit=0", 2, None)):
        jsync, tsync = _syncs("mpi_sgd", p, None)
        for mod, model, opt, sync, kw in (
                (JSD, jmodel, jsgd.sgd(0.1, momentum=0.9), jsync, {}),
                (TSD, tmodel, tsgd.sgd(0.1, 0.9), tsync, {"device": "cpu"})):
            if match is None:        # corrupt leaves token batches alone
                mod.drive(model, opt, sync, [], p=p, faults=faults, **kw)
                continue
            with pytest.raises(ValueError, match=match):
                mod.drive(model, opt, sync, [], p=p, faults=faults, **kw)
    overlap = SyncConfig(mode="mpi_sgd", policy=CollectivePolicy(
        method="ring", num_rings=1, overlap=True))
    with pytest.raises(ValueError, match="overlap"):
        TSD.drive(tmodel, tsgd.sgd(0.1, 0.9), overlap, [], p=2, device="cpu",
                  faults="kill@1:unit=0")
    with pytest.raises(ValueError, match="REAL mesh"):
        TSD.drive(tmodel, tsgd.sgd(0.1, 0.9), _syncs("mpi_sgd", 2, None)[1], [],
                  mesh=object(), device="cpu", faults="kill@1:unit=0")
