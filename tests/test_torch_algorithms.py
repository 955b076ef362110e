"""The port's six modes (``repro_torch.core.algorithms.run``) against the
reference's (``repro.core.algorithms.run``) on reduced qwen2-0.5b with
bridged weights (the reference's ``init_fn`` ignores its key and returns
them), the same synthetic bigram shards per worker and a held-out eval
batch.

Tolerances:
- the simulated clock exactly equal: ``History.times``, ``epochs``,
  ``epoch_time``, ``mean_staleness``, ``live_clients`` (numpy draws and
  cost-model floats as the reference makes them);
- losses and eval metrics rtol 1e-4;
- the final params (sync, async) or center (ESGD) that the last eval saw:
  rtol 1e-3 / atol 1e-5 over the f32 wire;
- over the int8 wire a band: every element within 2e-3 of the
  reference's, and the f32 tolerance above for all but 1 % of the
  elements (and 20 % of any one leaf). The intra-client allreduce runs
  the per-hop codec, whose scale the reference's compiled emulation
  computes as a multiplication by f32(1/127) (one ulp off on ~4 % of the
  buckets), and the two frameworks' gradients differ in the last bits,
  so a code next to a rounding boundary can flip; measured on this
  problem (CPU): 0.001 % (mpi-ESGD) and 0 % (dist-ESGD, which has no
  group collective) of the center's elements off the f32 tolerance.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.core import algorithms as JA, client as jclient, scheduler as jsched  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import algorithms as TA, client as tclient, scheduler as tsched  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch.train import make_grad_fn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

torch.set_num_threads(2)

DATA = dict(seed=0, vocab_size=256, seq_len=32, batch_size=2, steps_per_epoch=2)
BASE = dict(num_workers=4, num_clients=2, num_servers=1, lr=0.1, momentum=0.9,
            epochs=2, steps_per_epoch=2, esgd_interval=2, compute_time=0.2,
            jitter=0.1, model_bytes=1e7, seed=0)
CASES = [(m, None) for m in JA.MODES] + [("mpi_esgd", "int8"), ("dist_esgd", "int8")]


class _Problem:
    """Both frameworks' model, grad, eval and data on the same weights;
    each eval records the params it saw (the run's final state)."""

    def __init__(self):
        self.jmodel = jbuild_model(jreduced(jget_config("qwen2-0.5b")))
        self.tmodel = build_model(reduced(get_config("qwen2-0.5b")))
        self.p0 = jax.tree.map(np.asarray, self.jmodel.init(jax.random.key(0)))
        held = JTokenPipeline(JDataConfig(**DATA, shard=99)).batch_at(0, 0)
        self.jheld = {k: jnp.asarray(v) for k, v in held.items()}
        self.theld = {k: torch.from_numpy(np.asarray(v)) for k, v in held.items()}

        def jgrad(p, b):
            (loss, _), g = jax.value_and_grad(self.jmodel.loss_fn, has_aux=True)(p, b)
            return loss, g

        self.jgrad = jax.jit(jgrad)
        self.jloss = jax.jit(lambda p: self.jmodel.loss_fn(p, self.jheld)[0])
        self.tgrad_fn = make_grad_fn(self.tmodel)
        self.seen = {}

    def tgrad(self, p, b):
        loss, _, g = self.tgrad_fn(p, b)
        return loss, g

    def jeval(self, p):
        self.seen["jax"] = jax.tree.map(np.asarray, p)
        return float(self.jloss(p))

    def teval(self, p):
        self.seen["port"] = params_to_numpy(p)
        with torch.no_grad():
            return float(self.tmodel.loss_fn(p, self.theld)[0])

    def run_both(self, mode, wire):
        """Both runs; -> (reference History, port History, the final
        params or center each one's last eval saw)."""
        cfgs = []
        for A in (JA, TA):
            pol = {}
            if wire:
                pol["policy"] = A.CollectivePolicy(method="multi_ring",
                                                   num_rings=2, wire_dtype=wire)
            cfgs.append(A.AlgoConfig(mode=mode, **BASE, **pol))
        jh = JA.run(cfgs[0], lambda key: jax.tree.map(jnp.asarray, self.p0),
                    self.jgrad, self.jeval,
                    lambda w: JTokenPipeline(JDataConfig(**DATA, shard=w)))
        th = TA.run(cfgs[1], lambda gen: params_from_numpy(self.p0),
                    self.tgrad, self.teval,
                    lambda w: TokenPipeline(DataConfig(**DATA, shard=w)),
                    device="cpu")
        return jh, th, self.seen["jax"], self.seen["port"]


@pytest.fixture(scope="module")
def problem():
    return _Problem()


def _pairs(ref, port):
    want = jax.tree.leaves(ref)
    got = jax.tree.leaves(port)
    assert len(want) == len(got)
    return [(np.asarray(w, np.float32), np.asarray(g, np.float32))
            for w, g in zip(want, got)]


def _close_but_flips(ref, port, band=2e-3, key_frac=0.01, leaf_frac=0.2):
    off = total = 0
    for w, g in _pairs(ref, port):
        np.testing.assert_allclose(g, w, rtol=0, atol=band)
        bad = int((np.abs(g - w) > 1e-5 + 1e-3 * np.abs(w)).sum())
        assert bad <= leaf_frac * w.size, (w.shape, bad)
        off, total = off + bad, total + w.size
    assert off <= key_frac * total, (off, total)


@pytest.mark.parametrize("mode,wire", CASES, ids=lambda v: str(v))
def test_run_matches_reference(problem, mode, wire):
    jh, th, ref, port = problem.run_both(mode, wire)
    for f in ("times", "epochs", "epoch_time", "mean_staleness", "live_clients",
              "degraded_syncs", "late_pushes", "membership_epochs"):
        assert getattr(th, f) == getattr(jh, f), f
    assert len(th.losses) == len(jh.losses) and len(th.metrics) == 2
    np.testing.assert_allclose(th.losses, jh.losses, rtol=1e-4)
    np.testing.assert_allclose(th.metrics, jh.metrics, rtol=1e-4)
    if wire is None:
        for w, g in _pairs(ref, port):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5)
    else:
        _close_but_flips(ref, port)
    if mode.endswith("esgd") and wire == "int8":
        # every exchange's push crossed the packed int8 wire
        from repro_torch.core import flatbuf
        from repro_torch.core.cost_model import ps_wire_nbytes

        payload = flatbuf.spec_for(params_from_numpy(problem.p0)).payload
        pushes = BASE["epochs"] * BASE["steps_per_epoch"] * (
            4 if mode == "dist_esgd" else 2) // BASE["esgd_interval"]
        assert th.pushed_bytes == pushes * ps_wire_nbytes(payload, "int8")


def test_group_workers_and_engine_order_equal_reference():
    """The launcher's grouping and the async engine's completion order,
    event by event, with the reference's seeded jitter and the same
    returned communication times."""
    for W, C in ((4, 2), (12, 3), (8, 8), (6, 1)):
        assert [(str(i.ps), str(i.mpi), i.mpi.is_master)
                for i in tclient.group_workers(W, C)] == \
            [(str(i.ps), str(i.mpi), i.mpi.is_master)
             for i in jclient.group_workers(W, C)]
        ids = tclient.group_workers(W, C)
        assert [str(i.ps) for i in tclient.masters(ids)] == \
            [str(i.ps) for i in jclient.masters(jclient.group_workers(W, C))]
        assert len(tclient.client_members(ids, C - 1)) == W // C
    with pytest.raises(ValueError):
        tclient.group_workers(5, 2)
    for seed, C, jitter in ((0, 2, 0.1), (3, 5, 0.3), (1, 4, 0.0)):
        events = {}
        for name, mod in (("jax", jsched), ("port", tsched)):
            timing = [mod.UnitTiming(0.2, jitter, np.random.default_rng((seed, u)))
                      for u in range(C)]
            engine = mod.AsyncEngine(C, timing)
            log = []

            def on_complete(unit, now, log=log):
                log.append((unit, now))
                return 0.01 * (unit + 1)

            engine.start()
            engine.run(7 * C, on_complete)
            events[name] = (log, engine.now)
        assert events["port"] == events["jax"]


def test_staleness_tracker_equals_reference():
    jt, tt = jsched.StalenessTracker(), tsched.StalenessTracker()
    for op, u in (("pull", 0), ("pull", 1), ("apply", 0), ("apply", 1),
                  ("pull", 1), ("apply", 0), ("apply", 1)):
        for t in (jt, tt):
            getattr(t, f"on_{op}")(u)
    assert tt.history == jt.history and tt.mean_staleness() == jt.mean_staleness()


def test_algo_config_policy_mirrors_equal_reference():
    """The one policy field and its flat mirrors resolve as the
    reference's, through construction and ``dataclasses.replace``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for kw in ({}, {"wire_dtype": "int8"}, {"allreduce_method": "ring"},
                   {"overlap": True}, {"bucket_bytes": 4096}):
            j = JA.AlgoConfig(mode="mpi_esgd", **kw)
            t = TA.AlgoConfig(mode="mpi_esgd", **kw)
            assert t.policy.to_dict() == j.policy.to_dict(), kw
            for f in ("allreduce_method", "wire_dtype", "bucket_bytes",
                      "overlap", "collective_wire_dtype", "effective_wire_dtype",
                      "effective_clients", "workers_per_client"):
                assert getattr(t, f) == getattr(j, f), (kw, f)
            t2 = dataclasses.replace(t, lr=0.5)
            j2 = dataclasses.replace(j, lr=0.5)
            assert t2.policy.to_dict() == j2.policy.to_dict()
    assert TA._comm_times(TA.AlgoConfig(mode="mpi_esgd", wire_dtype="bf16")) == \
        JA._comm_times(JA.AlgoConfig(mode="mpi_esgd", wire_dtype="bf16"))
    with pytest.raises(ValueError, match="wire_dtype='int8'"):
        TA.AlgoConfig(mode="mpi_sgd", compress_push=True)


def test_run_guards(problem):
    cfg = TA.AlgoConfig(mode="mpi_sgd", **{k: v for k, v in BASE.items()})
    args = (lambda gen: params_from_numpy(problem.p0), problem.tgrad,
            problem.teval, lambda w: TokenPipeline(DataConfig(**DATA, shard=w)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TA.run(cfg, *args)                      # the card by default
    with pytest.raises(ValueError, match="mode must be one of"):
        TA.run(dataclasses.replace(cfg, mode="sgd"), *args, device="cpu")
    with pytest.raises(ValueError, match="divide into clients"):
        TA.run(dataclasses.replace(cfg, num_clients=3), *args, device="cpu")
    # server_faults configure the socket tier's servers: the in-process
    # runner ignores them, as the reference does; faults run (a sync kill
    # needs a barrier timeout, as in the reference)
    short = dataclasses.replace(cfg, epochs=1, steps_per_epoch=1)
    clean = TA.run(short, *args, device="cpu")
    ignored = TA.run(dataclasses.replace(short, server_faults="kill@1:unit=0"),
                     *args, device="cpu")
    assert ignored.losses == clean.losses and ignored.times == clean.times
    with pytest.raises(ValueError, match="barrier_timeout"):
        TA.run(dataclasses.replace(short, faults="kill@0:unit=1"), *args, device="cpu")
    faulted = TA.run(dataclasses.replace(short, faults="kill@0:unit=1",
                                         barrier_timeout=1.0), *args, device="cpu")
    assert (faulted.live_clients, faulted.membership_epochs,
            faulted.degraded_syncs) == (1, 1, 1)
    with pytest.raises(ValueError, match="init_fn returned params on"):
        TA.run(cfg, lambda gen: params_from_numpy(problem.p0, device="meta"),
               *args[1:], device="cpu")
    seen = []
    TA.run(dataclasses.replace(cfg, epochs=1, steps_per_epoch=1),
           lambda gen: seen.append(gen.initial_seed()) or params_from_numpy(problem.p0),
           *args[1:], device="cpu")
    assert seen == [cfg.seed]
