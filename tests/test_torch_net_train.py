"""Training over the port's socket PS tier (``repro_torch.net``), two
workers in threads of this process, held against the in-process runs and
across frameworks.

- port rendezvous + port ``KVServer`` + port workers over tcp and over
  loopback: dist_sgd f32 ``==`` the port's in-process ``algorithms.run``
  (per-step mean loss, eval metrics); dist_esgd f32 with the exchanges in
  the in-process engine's order (jitter 0, a turnstile) ``==`` it too.
  Over a bf16 / int8 wire the socket run is not the in-process one — the
  in-process sync runner puts no codec on its PS leg, the in-process
  ESGD push rides the streaming kernel's codec and reads its old center
  unquantized — so there tcp ``==`` loopback ``==`` a JAX server, and the
  in-process run is a band (the codec's rounding, 2e-2 of a loss).
  Every push carries ``cost_model.ps_wire_nbytes(spec.size, wd)`` bytes.
- across frameworks over tcp: port workers against the reference's
  ``KVServer`` + ``Rendezvous`` ``==`` the port's in-process run; the
  reference's ``run_worker`` threads against the port's server and
  rendezvous ``==`` the reference's in-process ``algorithms.run``.
- logreg8's grad / eval / pipeline against the reference's on bridged
  params (rtol 1e-5: two frameworks' f32 matmuls and logsumexp).
- a worker killed by its schedule and respawned resumes from its parked
  state: the two attempts `==` the uninterrupted in-process run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_net import Tier, epoch_means, one_thread, run_job, step_means  # noqa: E402
from repro.core import algorithms as JA  # noqa: E402
from repro.net import problem as jproblem, rendezvous as jrdzv  # noqa: E402
from repro_torch.core import algorithms as TA, cost_model, flatbuf  # noqa: E402
from repro_torch.net import rendezvous as trdzv  # noqa: E402
from repro_torch.net.problem import build_problem  # noqa: E402
from repro_torch.net.worker import _opt_spec, run_worker  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _one_thread():
    """The exact holds below need one CPU thread (``one_thread``)."""
    with one_thread():
        yield


BASE = dict(num_workers=2, num_clients=2, num_servers=1, lr=0.1,
            momentum=0.9, epochs=2, steps_per_epoch=2, esgd_interval=1,
            jitter=0.0, seed=0)
BAND = 2e-2


def _cfg(mode, wd=None, A=TA):
    return A.AlgoConfig(mode=mode, **BASE, policy=A.CollectivePolicy(
        method="multi_ring", num_rings=2, wire_dtype=wd))


def _inprocess(cfg):
    prob = build_problem("logreg8", device="cpu")
    return TA.run(cfg, prob.init_fn, prob.grad_fn, prob.eval_fn,
                  prob.make_pipeline, device="cpu")


def _losses(mode, outs):
    return (step_means(outs) if mode == "dist_sgd"
            else epoch_means(outs, BASE["steps_per_epoch"]))


def _bytes_per_push(outs, wd):
    """Every worker pushed once a step (4 steps), each push and each reply
    ``ps_wire_nbytes`` of the packed buffer."""
    n = flatbuf.spec_for(build_problem("logreg8", device="cpu").init_fn(
        torch.Generator().manual_seed(0))).size
    for out in outs.values():
        kv = out["kv"]
        assert kv["push_count"] == 4
        assert kv["pushed_bytes"] == kv["push_count"] * cost_model.ps_wire_nbytes(n, wd)
        assert kv["pulled_bytes"] == kv["pushed_bytes"]


def _run(cfg, **kw):
    outs, stats = run_job(trdzv.algo_to_dict(cfg), ordered=cfg.mode == "dist_esgd",
                          **kw)
    assert stats["degraded_syncs"] == 0 and stats["late_pushes"] == 0
    assert stats["live"] == [0, 1]
    return outs, stats


@pytest.mark.parametrize("transport", ["tcp", "loopback"])
@pytest.mark.parametrize("mode", ["dist_sgd", "dist_esgd"])
def test_port_tier_f32_equals_inprocess(mode, transport):
    cfg = _cfg(mode)
    outs, _ = _run(cfg, transport=transport)
    hist = _inprocess(cfg)
    assert _losses(mode, outs) == hist.losses
    assert outs[1]["metrics"] == hist.metrics
    if mode == "dist_sgd":
        assert outs[0]["metrics"] == hist.metrics
    else:
        assert [outs[r]["exchanges"] for r in sorted(outs)] == [4, 4]
    _bytes_per_push(outs, None)


@pytest.mark.parametrize("mode,wd", [("dist_sgd", "bf16"), ("dist_sgd", "int8"),
                                     ("dist_esgd", "int8")])
def test_port_tier_wire_dtypes(mode, wd):
    """tcp == loopback == the same port workers against the reference's
    server (its own codec and sum); the in-process run within the band."""
    cfg = _cfg(mode, wd)
    tcp, _ = _run(cfg, transport="tcp")
    loop, _ = _run(cfg, transport="loopback")
    jserver, _ = _run(cfg, transport="tcp", package="repro")
    for other in (loop, jserver):
        assert _losses(mode, other) == _losses(mode, tcp)
        assert sorted(other) == sorted(tcp)
        for r in tcp:
            assert other[r]["metrics"] == tcp[r]["metrics"]
    _bytes_per_push(tcp, wd)
    _bytes_per_push(jserver, wd)
    hist = _inprocess(cfg)
    np.testing.assert_allclose(_losses(mode, tcp), hist.losses, rtol=BAND)


@pytest.mark.parametrize("mode", ["dist_sgd", "dist_esgd"])
def test_port_workers_against_reference_server(mode):
    cfg = _cfg(mode)
    outs, stats = _run(cfg, package="repro")
    hist = _inprocess(cfg)
    assert _losses(mode, outs) == hist.losses
    assert outs[1]["metrics"] == hist.metrics
    _bytes_per_push(outs, None)


@pytest.mark.parametrize("mode", ["dist_sgd", "dist_esgd"])
def test_reference_workers_against_port_server(mode):
    jcfg = _cfg(mode, A=JA)
    outs, stats = run_job(jrdzv.algo_to_dict(jcfg), worker_package="repro",
                          ordered=mode == "dist_esgd")
    assert stats["degraded_syncs"] == 0 and stats["live"] == [0, 1]
    prob = jproblem.build_problem("logreg8")
    hist = JA.run(jcfg, prob.init_fn, prob.grad_fn, prob.eval_fn,
                  prob.make_pipeline)
    assert _losses(mode, outs) == hist.losses
    assert outs[1]["metrics"] == hist.metrics


def test_logreg8_matches_reference_on_bridged_params():
    jprob = jproblem.build_problem("logreg8")
    tprob = build_problem("logreg8", device="cpu")
    p = tprob.init_fn(torch.Generator().manual_seed(3))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jprob.init_fn(jax.random.key(0)).items()}
    p["b"] = torch.linspace(-0.1, 0.1, 10)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    for w in (0, 1):
        jb = jprob.make_pipeline(w).batch_at(1, 3)
        tb = tprob.make_pipeline(w).batch_at(1, 3)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        jl, jg = jprob.grad_fn(jp, jb)
        tl, tg = tprob.grad_fn(p, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-5, atol=1e-7)
    assert tprob.eval_fn(p) == jprob.eval_fn(jp)
    assert build_problem("logreg8", device="cpu") is tprob
    with pytest.raises(ValueError, match="unknown problem"):
        build_problem("mnist", device="cpu")


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_killed_worker_resumes_from_parked_state(optimizer):
    """A worker killed before step 2 (its fault schedule) and respawned
    (attempt 1) re-joins at a new epoch, pulls its exact-f32 parked params
    and optimizer state (``get_state``: ``restore_leg_bytes`` of them) and
    goes on from step 2: the two attempts' losses and the eval ``==`` the
    uninterrupted in-process run."""
    base = dict(mode="dist_sgd", num_workers=1, num_clients=1, num_servers=1,
                epochs=1, steps_per_epoch=4, checkpoint_every=1, seed=0,
                optimizer=optimizer, lr=0.1 if optimizer == "sgd" else 0.01)
    cfg = TA.AlgoConfig(**base, faults="kill@2:unit=0")
    with Tier(trdzv.algo_to_dict(cfg), workers=1) as tier:
        first = run_worker(rank=0, rendezvous_addr=tier.addr, on_kill=lambda: None,
                           device="cpu")
        second = run_worker(rank=0, rendezvous_addr=tier.addr, attempt=1,
                            device="cpu")
        assert tier.stats()["state_units"] == [0]
    assert first["killed_at"] == 2 and first["gsteps"] == [0, 1]
    assert second["resumed_from"] == 1 and second["gsteps"] == [2, 3]
    assert second["resume"] == {"step": 1, "epoch": 3}
    hist = _inprocess(TA.AlgoConfig(**base))
    assert first["losses"] + second["losses"] == hist.losses
    assert second["metrics"] == hist.metrics
    prob = build_problem("logreg8", device="cpu")
    params = prob.init_fn(torch.Generator().manual_seed(0))
    state = TA._make_opt(cfg, params).init(params)
    n = flatbuf.spec_for(params).size + _opt_spec(state).size
    assert second["kv"]["state_bytes_in"] == cost_model.restore_leg_bytes(n)
