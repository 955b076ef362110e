"""The port's fault injection (``repro_torch.core.faults``) against the
reference's (``repro.core.faults``): the schedule grammar, every injector
lookup, and ``corrupt``'s seeded noise bit for bit; then the faulted paths
of ``algorithms.run`` (the faulted sync runner, the injector branches of
the async and elastic runners) against the reference's on its own tiny
problem (``tests/test_algorithms.py``: logistic regression on synthetic
8 × 8 images, 4 workers in 2 clients, 2 epochs of 10 steps), with the
reference's own schedules.

Tolerances: the simulated clock and the robustness counters exactly equal
(``times``, ``epochs``, ``epoch_time``, ``mean_staleness``,
``degraded_syncs``, ``late_pushes``, ``live_clients``,
``membership_epochs``): they are numpy draws and cost-model floats made
as the reference makes them, and a fault replay must be bit-identical.
Losses and the held-out loss the eval reports rtol 1e-4, atol 1e-6: the
problem is separable, so its loss falls below 1e-3 within a dozen steps,
where ``logsumexp − gold`` cancels and the two frameworks' f32 sums differ
by ~5e-8 absolute (measured up to 4.5e-8). The final params
rtol 1e-3 / atol 1e-5 (f32 matmuls of two frameworks). Over the int8 wire
the final params are held to the band of ``tests/test_torch_algorithms.py``
(every element within 2e-3; the f32 tolerance for all but 1 %): the
intra-client allreduce runs the per-hop codec, whose scale the
reference's compiled emulation computes as a multiplication by
f32(1/127), so a code next to a rounding boundary can flip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import algorithms as JA, faults as JF  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, ImagePipeline  # noqa: E402
from repro_torch.core import algorithms as TA, faults as TF  # noqa: E402

torch.set_num_threads(2)

SCHEDULES = [
    "kill@12:unit=1;straggle@0:unit=3:factor=4:duration=20",
    "kill@2:unit=1;restart@2:unit=1:delay=0.1",
    "kill@3:unit=1;kill@5:unit=1;restart@4:unit=1;restart@9:unit=1:delay=2.5",
    "corrupt@5:unit=0:sigma=0.1;drop@3:unit=2:duration=2;delay@7:unit=1:factor=0.5",
    "straggle@2:unit=0:factor=3:duration=4;straggle@4:unit=0:factor=2;"
    "drop@0:unit=0:duration=3;delay@0:unit=0:factor=0.25;delay@0:unit=0",
]


# -- the schedule grammar and the lookups ----------------------------------------

@pytest.mark.parametrize("text", SCHEDULES)
def test_schedule_and_every_lookup_equal_reference(text):
    j = JF.FaultSchedule.parse(text, seed=7)
    t = TF.FaultSchedule.parse(text, seed=7)
    assert t.format() == j.format()
    assert TF.FaultSchedule.parse(t.format(), seed=7) == t
    assert [dataclasses.astuple(e) for e in t.events] == \
        [dataclasses.astuple(e) for e in j.events]
    assert t.kinds == j.kinds and t.seed == j.seed
    ji, ti = JF.injector(text, seed=7), TF.injector(text, seed=7)
    for unit in range(4):
        for attempt in range(3):
            assert ti.killed_at(unit, attempt) == ji.killed_at(unit, attempt)
            assert ti.restart_delay(unit, attempt) == ji.restart_delay(unit, attempt)
        for step in range(14):
            assert ti.restart_units(step) == ji.restart_units(step)
            assert ti.straggle_factor(unit, step) == ji.straggle_factor(unit, step)
            assert ti.delay(unit, step) == ji.delay(unit, step)
            assert ti.active(unit, step) == ji.active(unit, step)
            for attempt in range(4):
                assert ti.is_killed(unit, step, attempt) == \
                    ji.is_killed(unit, step, attempt)
                assert ti.should_drop(unit, step, attempt) == \
                    ji.should_drop(unit, step, attempt)
            for retries, backoff in ((0, 0.05), (2, 0.05), (3, 0.2)):
                assert TF.delivery_time(ti, unit, step, 1.25, retries=retries,
                                        backoff=backoff) == \
                    JF.delivery_time(ji, unit, step, 1.25, retries=retries,
                                     backoff=backoff)


def test_normalizers_and_malformed_schedules_equal_reference():
    assert TF.as_schedule(None) is None and TF.as_schedule("") is None
    assert TF.as_schedule(TF.FaultSchedule()) is None
    s = TF.as_schedule("kill@1:unit=0", seed=3)
    assert s.seed == 3 and TF.as_schedule(s) is s
    assert TF.injector(None) is None and TF.injector(" ; ") is None
    assert TF.delivery_time(None, 0, 0, 1.5) == 1.5
    for bad in ("kill:unit=1", "kill@3", "kill@3:unit=1:bogus=2",
                "explode@3:unit=1", "kill@3:unit", "drop@1:unit=0:delay=2",
                "kill@-1:unit=0", "drop@1:unit=0:duration=0"):
        for mod in (JF, TF):
            with pytest.raises(ValueError):
                mod.FaultSchedule.parse(bad)


def test_corrupt_noise_is_the_reference_noise_bit_for_bit():
    """numpy draws the noise in f32 per (seed, unit, step), leaf by leaf in
    flatten order; the port casts it to each leaf's dtype before the add,
    as the reference does, and leaves non-float leaves alone."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "h": rng.standard_normal((5,)).astype(np.float32),
            "n": np.arange(5, dtype=np.int32),
            "a": rng.standard_normal((2, 7)).astype(np.float32)}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jtree["h"] = jtree["h"].astype(jnp.bfloat16)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    ttree["h"] = torch.tensor(np.asarray(jtree["h"].astype(jnp.float32))).bfloat16()
    text = "corrupt@4:unit=1:sigma=0.5;corrupt@4:unit=1:sigma=0.25;corrupt@6:unit=0"
    ji, ti = JF.injector(text, seed=11), TF.injector(text, seed=11)
    for unit, step in ((1, 4), (0, 6), (0, 4), (1, 5)):
        want = ji.corrupt(jtree, unit, step)
        got = ti.corrupt(ttree, unit, step)
        for k in tree:
            w = np.asarray(want[k].astype(jnp.float32)
                           if want[k].dtype == jnp.bfloat16 else want[k])
            g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
            assert got[k].dtype == ttree[k].dtype
            np.testing.assert_array_equal(g, w, err_msg=f"{k} unit {unit} step {step}")
        if (unit, step) in ((1, 5), (0, 4)):
            assert got is ttree                  # nothing scheduled
        assert torch.equal(got["n"], ttree["n"])
    assert not torch.equal(ti.corrupt(ttree, 1, 4)["w"], ttree["w"])


# -- the faulted runners, on the reference's tiny problem -----------------------------

D, NCLS = 8 * 8 * 3, 10


class _Pipe:
    """The reference's ImagePipeline, its batches handed over as tensors."""

    def __init__(self, pipe):
        self.pipe = pipe

    def batch_at(self, epoch, step):
        return {k: torch.tensor(np.asarray(v))
                for k, v in self.pipe.batch_at(epoch, step).items()}


def _image_pipe(shard, batch_size=16, steps=10):
    return ImagePipeline(JDataConfig(seed=0, batch_size=batch_size,
                                     steps_per_epoch=steps, shard=shard),
                         image_size=8)


class _Problem:
    """Logistic regression in both frameworks, from the same weights."""

    def __init__(self):
        self.p0 = {"w": (np.random.default_rng(0).standard_normal((D, NCLS))
                         * 0.01).astype(np.float32),
                   "b": np.zeros((NCLS,), np.float32)}
        held = _image_pipe(12345, batch_size=256, steps=1).batch_at(999, 0)
        self.jheld = held
        self.theld = {k: torch.tensor(np.asarray(v)) for k, v in held.items()}
        self.jgrad = jax.jit(jax.value_and_grad(self._jloss))
        self.seen = {}

    @staticmethod
    def _jloss(params, batch):
        x = batch["images"].reshape(batch["images"].shape[0], -1)
        logits = x @ params["w"] + params["b"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, batch["labels"][:, None], 1)[:, 0]
        return jnp.mean(lse - gold)

    @staticmethod
    def _tloss(params, batch):
        x = batch["images"].reshape(batch["images"].shape[0], -1)
        logits = x @ params["w"] + params["b"]
        gold = logits.gather(1, batch["labels"].long()[:, None])[:, 0]
        return (torch.logsumexp(logits, -1) - gold).mean()

    def tgrad(self, params, batch):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = self._tloss(p, batch)
        gw, gb = torch.autograd.grad(loss, [p["w"], p["b"]])
        return loss.detach(), {"w": gw, "b": gb}

    def jeval(self, params):
        self.seen["jax"] = jax.tree.map(np.asarray, params)
        return float(self._jloss(params, self.jheld))

    def teval(self, params):
        self.seen["port"] = {k: v.numpy().copy() for k, v in params.items()}
        with torch.no_grad():
            return float(self._tloss(params, self.theld))

    def run_both(self, **kw):
        base = dict(num_workers=4, num_clients=2, num_servers=1, lr=0.05,
                    epochs=2, steps_per_epoch=10, esgd_interval=4,
                    compute_time=0.2, jitter=0.1, model_bytes=1e7, seed=0)
        base.update(kw)
        wire = base.pop("wire_dtype", None)
        cfgs = [A.AlgoConfig(**base, policy=A.CollectivePolicy(
            method="multi_ring", num_rings=2, wire_dtype=wire)) for A in (JA, TA)]
        jh = JA.run(cfgs[0],
                    lambda key: {k: jnp.asarray(v) for k, v in self.p0.items()},
                    self.jgrad, self.jeval, _image_pipe)
        th = TA.run(cfgs[1],
                    lambda gen: {k: torch.from_numpy(v.copy()) for k, v in self.p0.items()},
                    self.tgrad, self.teval, lambda w: _Pipe(_image_pipe(w)),
                    device="cpu")
        return jh, th, self.seen["jax"], self.seen["port"]


@pytest.fixture(scope="module")
def problem():
    return _Problem()


SYNC_SCHED = "kill@12:unit=1;straggle@0:unit=0:factor=3:duration=5"
ASYNC_SCHED = "kill@8:unit=1;drop@3:unit=0:duration=9"
ESGD_SCHED = "kill@10:unit=1;straggle@0:unit=0:factor=3:duration=8"
MIXED_SCHED = ("corrupt@2:unit=0:sigma=0.1;delay@3:unit=1:factor=2;"
               "drop@5:unit=1;drop@6:unit=0:duration=3;kill@15:unit=0;"
               "restart@16:unit=0")
RUNS = {
    "mpi_sgd": dict(mode="mpi_sgd", faults=SYNC_SCHED, barrier_timeout=1.0),
    "dist_sgd": dict(mode="dist_sgd", faults=SYNC_SCHED, barrier_timeout=1.0),
    "mpi_sgd-mixed": dict(mode="mpi_sgd", faults=MIXED_SCHED, barrier_timeout=0.5),
    "mpi_asgd": dict(mode="mpi_asgd", faults=ASYNC_SCHED),
    "dist_asgd-mixed": dict(mode="dist_asgd", faults=MIXED_SCHED),
    "mpi_esgd-int8-per-leaf": dict(mode="mpi_esgd", faults=ESGD_SCHED,
                                   wire_dtype="int8", flat_exchange=False),
    "dist_esgd-mixed": dict(mode="dist_esgd", faults=MIXED_SCHED),
    # restart events are ignored in process: the unit stays as it was
    "mpi_sgd-restart-only": dict(mode="mpi_sgd", faults="restart@1:unit=1",
                                 barrier_timeout=1.0),
}
COUNTERS = ("times", "epochs", "epoch_time", "mean_staleness", "degraded_syncs",
            "late_pushes", "live_clients", "membership_epochs")


@pytest.mark.parametrize("name", list(RUNS))
def test_faulted_run_matches_reference(problem, name):
    jh, th, ref, port = problem.run_both(**RUNS[name])
    for f in COUNTERS:
        assert getattr(th, f) == getattr(jh, f), f
    assert len(th.losses) == len(jh.losses)
    np.testing.assert_allclose(th.losses, jh.losses, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(th.metrics, jh.metrics, rtol=1e-4, atol=1e-6)
    for k in ref:
        if RUNS[name].get("wire_dtype") == "int8":
            np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=2e-3)
            bad = np.abs(port[k] - ref[k]) > 1e-5 + 1e-3 * np.abs(ref[k])
            assert bad.mean() <= 0.01, (k, bad.mean())
        else:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-3, atol=1e-5)
    if name in ("mpi_sgd", "dist_sgd"):
        # the reference's own outcome: the detection round degrades, the
        # dead client is evicted in one membership epoch
        assert th.degraded_syncs >= 1 and th.live_clients == \
            TA.AlgoConfig(**{**RUNS[name], "num_workers": 4}).effective_clients - 1
        assert th.membership_epochs == 1
    if name == "mpi_asgd":
        assert th.live_clients == 1 and th.late_pushes == 1
    if name == "mpi_esgd-int8-per-leaf":
        # every delivered exchange crossed the per-leaf QBLOCK codec
        from repro_torch.kernels.quant_bucket.ops import compressed_bytes
        assert th.live_clients == 1 and th.membership_epochs == 1
        assert th.pushed_bytes % compressed_bytes(
            {k: torch.from_numpy(v) for k, v in problem.p0.items()}) == 0


def test_fault_guards_and_ignored_knobs(problem):
    """A sync kill without a barrier timeout raises as the reference's;
    ``server_faults``, the crash-recovery knobs and ``restart`` events are
    ignored by the in-process runners, and an empty schedule runs the
    clean path."""
    args = (lambda gen: {k: torch.from_numpy(v.copy()) for k, v in problem.p0.items()},
            problem.tgrad, problem.teval, lambda w: _Pipe(_image_pipe(w, steps=2)))
    base = dict(num_workers=4, num_clients=2, num_servers=1, epochs=1,
                steps_per_epoch=2, compute_time=0.2, jitter=0.1, model_bytes=1e7)
    for mod, run_args in ((JA, None), (TA, args)):
        with pytest.raises(ValueError, match="barrier_timeout"):
            cfg = mod.AlgoConfig(mode="mpi_sgd", faults="kill@1:unit=0", **base)
            if run_args is None:
                mod.run(cfg, lambda key: {k: jnp.asarray(v) for k, v in problem.p0.items()},
                        problem.jgrad, problem.jeval, _image_pipe)
            else:
                mod.run(cfg, *run_args, device="cpu")
    clean = TA.run(TA.AlgoConfig(mode="mpi_sgd", **base), *args, device="cpu")
    for extra in (dict(server_faults="kill@1:unit=0", checkpoint_every=1,
                       restarts=2, restart_backoff=0.5),
                  dict(faults="", push_retries=5, barrier_timeout=0.5)):
        h = TA.run(TA.AlgoConfig(mode="mpi_sgd", **base, **extra), *args, device="cpu")
        assert h.losses == clean.losses and h.times == clean.times, extra
        assert h.live_clients == 2 and h.membership_epochs == 0


def test_barrier_releases_at_the_deadline_the_runner_computes():
    """The sync runner releases a degraded round at ``first + timeout``;
    for some arrival times that sum's difference from ``first`` rounds
    below the timeout, and the reference's store raises. The port's store
    releases there, and agrees with the reference wherever it runs."""
    first, timeout = 3.1848084366072715, 0.3
    assert (first + timeout) - first < timeout
    from repro.core.kvstore import KVStore as JKV
    from repro_torch.core.kvstore import KVStore as TKV

    def stores():
        out = []
        for KV, wrap in ((JKV, jnp.asarray), (TKV, torch.tensor)):
            kv = KV.create("dist_sync", num_workers=2, barrier_timeout=timeout)
            kv.init("g", wrap(np.zeros(3, np.float32)))
            kv.push("g", wrap(np.ones(3, np.float32)), at=first)
            out.append(kv)
        return out

    jkv, tkv = stores()
    with pytest.raises(RuntimeError, match="barrier incomplete"):
        jkv.pull("g", now=first + timeout)
    assert torch.equal(tkv.pull("g", now=first + timeout)[0], torch.ones(3))
    assert (tkv.degraded_syncs, tkv.last_barrier_count) == (1, 1)
    for now in (first + 0.29, first + 0.31):   # either side of it: alike
        jkv, tkv = stores()
        if now < first + timeout:
            for kv in (jkv, tkv):
                with pytest.raises(RuntimeError, match="barrier incomplete"):
                    kv.pull("g", now=now)
            continue
        np.testing.assert_array_equal(tkv.pull("g", now=now)[0].numpy(),
                                      np.asarray(jkv.pull("g", now=now)[0]))
        assert tkv.degraded_syncs == jkv.degraded_syncs == 1
