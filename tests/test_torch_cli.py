"""The port's run settings and train CLI against the reference's:
``TrainSettings`` field for field, its ``sync_config()`` and
``fault_schedule()``; every accepted flag lowered by both CLIs' ``main``
to the same optimizer, sync config and first batch (the reference's
``train_loop`` stubbed, so no JAX compute runs); the header fields; and a
few real reduced runs of both CLIs from the same weights, losses held at
rtol 1e-4; and ``--transport tcp`` workers against an in-thread port
rendezvous and KV server, their losses ``==`` the in-process run."""
import dataclasses
import importlib
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from _torch_net import Tier, one_thread, run_threads, step_means  # noqa: E402

jtrain = importlib.import_module("repro.launch.train")
torch.set_num_threads(2)


def _plain(value):
    """A field value in a form both frameworks compare: policies by their
    dict, dtypes by name."""
    if hasattr(value, "to_dict"):
        return value.to_dict()
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    if value is not None and type(value).__module__.startswith(("jax", "numpy", "ml_dtypes")):
        return str(np.dtype(value))
    return value


def _fields(obj) -> dict:
    return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


SETTINGS = {
    "defaults": {},
    "esgd": dict(sync_mode="mpi_esgd", num_clients=2, esgd_alpha=0.3, esgd_interval=4),
    "no-flat-exchange": dict(sync_mode="mpi_esgd", flat_exchange=False),
    "fsdp": dict(fsdp=True),
    "microbatch": dict(microbatch=2, optimizer_name="adamw", lr=3e-3),
    "faults": dict(faults="kill@12:unit=1;straggle@0:unit=3:factor=4",
                   barrier_timeout=1.5),
    "int8-ring": dict(policy="ring-int8"),
    "flat-mirrors": dict(allreduce_method="multi_ring", num_rings=3,
                         bucket_bytes=1 << 20),
}


def _both(kw):
    """The reference's and the port's TrainSettings from the same kwargs
    (deprecation warnings of the flat mirrors silenced alike)."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("policy") == "ring-int8":
        jkw["policy"] = jcomm.CollectivePolicy(method="ring", wire_dtype="int8")
        tkw["policy"] = tcomm.CollectivePolicy(method="ring", wire_dtype="int8")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jbase.TrainSettings(**jkw), tbase.TrainSettings(**tkw)


def test_esgd_settings_construct():
    s = tbase.TrainSettings(sync_mode="mpi_esgd", esgd_interval=4)
    assert s.sync_config().esgd_interval == 4 and s.sync_config().mode == "mpi_esgd"


@pytest.mark.parametrize("kw", SETTINGS.values(), ids=SETTINGS.keys())
def test_train_settings_and_sync_config_equal_reference(kw):
    j, t = _both(kw)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert _fields(t) == _fields(j)
    assert t.policy.to_dict() == j.policy.to_dict()
    js, ts = j.sync_config(), t.sync_config()
    assert _fields(ts) == _fields(js)
    assert ts.policy.to_dict() == js.policy.to_dict()
    ts.validate()
    js.validate()


@pytest.mark.parametrize("faults", ["", "kill@12:unit=1",
                                    "straggle@0:unit=3:factor=4:duration=2;"
                                    "drop@2:unit=0:duration=1;kill@3:unit=1",
                                    "corrupt@1:unit=0:sigma=0.5;restart@4:unit=1"])
@pytest.mark.parametrize("seed", [0, 3])
def test_fault_schedule_equals_reference(faults, seed):
    j, t = _both(dict(faults=faults))
    js, ts = j.fault_schedule(seed), t.fault_schedule(seed)
    if js is None:
        assert ts is None
        return
    assert ts.seed == js.seed
    assert [dataclasses.asdict(e) for e in ts.events] == \
        [dataclasses.asdict(e) for e in js.events]


@pytest.mark.parametrize("faults", ["bogus", "kill@x:unit=1", "melt@2:unit=0"])
def test_fault_schedule_rejects_like_reference(faults):
    j, t = _both(dict(faults=faults))
    with pytest.raises(ValueError) as jerr:
        j.fault_schedule()
    with pytest.raises(ValueError) as terr:
        t.fault_schedule()
    assert str(terr.value) == str(jerr.value)


def test_validate_keeps_the_reference_messages():
    from repro.core.hierarchy import SyncConfig as JSync
    from repro_torch.core.hierarchy import SyncConfig as TSync

    cases = [dict(fsdp=True), dict(fused_update=False), dict(mode="mpi_esgd")]
    for kw in cases:
        jp = jcomm.CollectivePolicy(method="ring", num_rings=1, overlap=True)
        tp = tcomm.CollectivePolicy(method="ring", num_rings=1, overlap=True)
        with pytest.raises(ValueError) as jerr:
            JSync(policy=jp, **kw).validate()
        with pytest.raises(ValueError) as terr:
            TSync(policy=tp, **kw).validate()
        assert str(terr.value) == str(jerr.value)


# -- the CLIs --------------------------------------------------------------

class _Stub:
    """Stands in for a CLI's ``train_loop``: records what ``main`` lowered
    (the optimizer, the sync config, the first batch) and trains nothing."""

    def __init__(self):
        self.got = None

    def __call__(self, model, optimizer, sync, mesh, batches, **kw):
        self.got = (optimizer, sync, next(iter(batches)), model.cfg)
        return None, [{"step": 0, "loss": 0.0}]


def _reference_main(monkeypatch, argv, train_loop):
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + argv)
    monkeypatch.setattr(jtrain, "train_loop", train_loop)
    jtrain.main()


def _port_main(monkeypatch, argv, train_loop):
    monkeypatch.setattr(ttrain, "train_loop", train_loop)
    return ttrain.main(argv + ["--device", "cpu"])


def _header(out: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith("[train] client"))
    words = line.split()
    fields = {"client": words[2]}
    fields.update(w.split("=", 1) for w in words[3:] if "=" in w)
    return fields


ACCEPTED = {
    "defaults": [],
    "wire-int8": ["--wire-dtype", "int8"],
    "wire-bf16-tree": ["--wire-dtype", "bf16", "--allreduce", "tree"],
    "multi-ring": ["--allreduce", "multi_ring", "--num-rings", "3",
                   "--bucket-bytes", "1048576"],
    "scatter-gather": ["--allreduce", "scatter_gather"],
    "no-fused-update": ["--no-fused-update"],
    "flat-exchange": ["--no-flat-exchange", "--flat-exchange", "--fused-update"],
    "no-flat-exchange": ["--no-flat-exchange"],
    "faults": ["--faults", "kill@2:unit=1;straggle@0:unit=0:factor=3",
               "--barrier-timeout", "1.5"],
    "job-spec": ["--client", "1", "--num-clients", "2", "--scheduler", "h:7000",
                 "--shape", "prefill_32k", "--overlap-buckets", "2"],
    "overlap": ["--overlap", "--overlap-buckets", "3", "--wire-dtype", "bf16"],
    "adamw": ["--optimizer", "adamw", "--lr", "0.003", "--weight-decay", "0.1",
              "--state-dtype", "bf16"],
    "adagrad": ["--optimizer", "adagrad", "--lr", "0.01", "--momentum", "0.5"],
    "transport-fields": ["--transport", "loopback", "--tune-p", "4", "--mode",
                         "dist_sgd", "--problem", "logreg8", "--rendezvous", "h:9"],
    "checkpointing": ["--checkpoint-every", "2", "--checkpoint-dir", "ck",
                      "--restore", "", "--steps", "7"],
    "full-size": ["--full-size", "--arch", "qwen2-0.5b"],
}


@pytest.mark.parametrize("argv", ACCEPTED.values(), ids=ACCEPTED.keys())
def test_cli_lowers_like_reference(argv, monkeypatch, capsys):
    """Both ``main``s on the same flags: the same optimizer
    hyperparameters, sync config, model config and first batch (the data
    shard follows ``--client``), and the reference's header fields."""
    jstub, tstub = _Stub(), _Stub()
    _reference_main(monkeypatch, argv, jstub)
    jout = capsys.readouterr().out
    _port_main(monkeypatch, argv, tstub)
    tout = capsys.readouterr().out
    jopt, jsync, jbatch, jcfg = jstub.got
    topt, tsync, tbatch, tcfg = tstub.got
    assert _fields(tsync) == _fields(jsync)
    _, settings = ttrain.settings_from_args(ttrain.build_parser().parse_args(argv))
    assert _fields(settings.sync_config()) == _fields(jsync)
    assert {k: _plain(v) for k, v in topt.hyper.items()} == \
        {k: _plain(v) for k, v in jopt.hyper.items()}
    assert {k: v for k, v in _fields(tcfg).items()} == \
        {k: v for k, v in _fields(jcfg).items() if k in _fields(tcfg)}
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))
    theader = _header(tout)
    for key, value in _header(jout).items():
        assert theader[key] == value, key


def test_cli_bad_fault_schedule_fails_like_reference(monkeypatch):
    argv = ["--faults", "kill@two:unit=1"]
    with pytest.raises(ValueError) as jerr:
        _reference_main(monkeypatch, argv, _Stub())
    with pytest.raises(ValueError) as terr:
        _port_main(monkeypatch, argv, _Stub())
    assert str(terr.value) == str(jerr.value)


RUNS = {
    "int8-ring": ["--wire-dtype", "int8", "--allreduce", "ring"],
    "no-fused-update": ["--no-fused-update"],
    "multi-ring": ["--bucket-bytes", "1048576", "--num-rings", "3",
                   "--allreduce", "multi_ring"],
    "client-1": ["--client", "1"],
}


@pytest.mark.parametrize("argv", RUNS.values(), ids=RUNS.keys())
def test_cli_runs_match_reference_losses(argv, monkeypatch):
    """A real reduced run of each CLI, 3 steps on the CPU: the port starts
    from the reference's initial weights (its own init draws other
    numbers from the same seed), and the losses agree at rtol 1e-4."""
    argv = ["--steps", "3"] + argv
    init, jhist = {}, []
    make_state, loop = jtrain.make_train_state, jtrain.train_loop

    def jmake_state(*a, **kw):
        state = make_state(*a, **kw)
        init["params"] = jax.tree.map(np.asarray, state["params"])
        return state

    def jloop(*a, **kw):
        _, hist = loop(*a, **kw)
        jhist.extend(hist)
        return None, hist

    monkeypatch.setattr(jtrain, "make_train_state", jmake_state)
    _reference_main(monkeypatch, argv, jloop)

    tmake_state = ttrain.make_train_state

    def from_reference(*a, **kw):
        state = tmake_state(*a, **kw)
        state["params"] = params_from_numpy(init["params"])
        return state

    monkeypatch.setattr(ttrain, "make_train_state", from_reference)
    thist = ttrain.main(argv + ["--device", "cpu"])
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)


def test_launcher_command_runs_in_the_port(capsys):
    """The worker command the reference launcher emits
    (``tests/test_launch.py``'s), through the port's CLI on the CPU: it
    trains and prints the reference's header fields."""
    hist = ttrain.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                        "--client", "0", "--num-clients", "2",
                        "--scheduler", "frontend-0:9091", "--fused-update",
                        "--bucket-bytes", "1048576", "--steps", "3",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    header = _header(out)
    assert header["client"] == "0/2" and header["scheduler"] == "frontend-0:9091"
    assert header["fused_update"] == "True" and header["bucket_bytes"] == "1048576"
    for key in ("arch", "shape", "optimizer", "wire_dtype", "state_dtype", "overlap",
                "overlap_buckets", "faults", "barrier_timeout"):
        assert key in header
    assert "[train] done" in out


def test_cli_transport_tcp_trains_like_inprocess(monkeypatch, capsys):
    """Two ``--transport tcp --device cpu`` workers (``--client`` gives the
    rank) against an in-thread port rendezvous and KV server: 3 dist_sgd
    steps each, the per-step mean loss ``==`` the in-process
    ``algorithms.run`` of the job config the rendezvous hands out."""
    from repro_torch.core import algorithms as TA
    from repro_torch.net.problem import build_problem
    from repro_torch.net.rendezvous import algo_to_dict

    monkeypatch.delenv("REPRO_RANK", raising=False)
    cfg = TA.AlgoConfig(mode="dist_sgd", num_workers=2, num_clients=2,
                        num_servers=1, epochs=1, steps_per_epoch=3, seed=0)
    with one_thread(), Tier(algo_to_dict(cfg), workers=2) as tier:
        losses = run_threads(lambda r: ttrain.main(
            ["--transport", "tcp", "--rendezvous", tier.addr, "--client", str(r),
             "--mode", "dist_sgd", "--device", "cpu"]), [0, 1])
        assert tier.stats()["push_count"] == {"grads": 6}
    out = capsys.readouterr().out
    for r in (0, 1):
        assert f"[train] transport worker {r} done: 3 steps" in out
    prob = build_problem("logreg8", device="cpu")
    with one_thread():
        hist = TA.run(cfg, prob.init_fn, prob.grad_fn, prob.eval_fn,
                      prob.make_pipeline, device="cpu")
    assert step_means({r: {"losses": l} for r, l in losses.items()}) == hist.losses
