"""The port's launcher and supervisor (``repro_torch.launch.{launcher,
supervisor}``) and run_local's record merging, against the reference's:
``JobSpec`` validation messages, ``build_job``'s dict field for field and
``emit_scripts``' files byte for byte after the package-name
substitution (``repro.`` -> ``repro_torch.``; the port's spec also
carries ``device``), the ``parse_script`` round trip, ``--device``
threaded only when asked for, the launcher CLI's ``--policy auto``, the
supervisor's scheduled / budget / give-up ladder with fake processes and
an injected clock (the semantics of tests/test_recovery.py), and the
metrics merge across spawn generations."""
import json
import os
import re
import sys
import warnings

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import cost_model as jcost  # noqa: E402
from repro.core.comm import CollectivePolicy as JPolicy  # noqa: E402
from repro.launch import analysis as janalysis, launcher as jl  # noqa: E402
from repro.launch import run_local as jrl, supervisor as jsup  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.core.comm import CollectivePolicy as TPolicy  # noqa: E402
from repro_torch.core.faults import injector  # noqa: E402
from repro_torch.launch import autotune as ttune, launcher as tl  # noqa: E402
from repro_torch.launch import run_local as trl  # noqa: E402
from repro_torch.launch.supervisor import JobFailed, RestartPolicy, Supervisor, Unit  # noqa: E402


def _sub(text: str) -> str:
    """The reference's text with the port's package name."""
    return re.sub(r"\brepro\.", "repro_torch.", text)


SPECS = {
    "pure-mpi": ((4, 0, 1, "qwen3-4b", "train_4k"), {}),
    "hybrid": ((8, 2, 2, "qwen3-4b", "train_4k", "multipod"), {}),
    "hybrid-knobs": ((8, 2, 2, "qwen2-0.5b", "train_4k"),
                     dict(optimizer="adamw", fused_update=True, flat_exchange=False,
                          state_dtype="bf16", faults="kill@2:unit=1",
                          barrier_timeout=1.5, restore="/ck/ckpt_3.npz")),
    "int8-ring-policy": ((8, 2, 2, "qwen3-4b", "train_4k"),
                         dict(policy=dict(method="ring", num_rings=1, wire_dtype="int8",
                                          overlap=True, overlap_buckets=6))),
    "multi-ring-bucketed": ((4, 1, 2, "qwen3-4b", "train_4k"),
                            dict(policy=dict(method="multi_ring", num_rings=4,
                                             bucket_bytes=1 << 22))),
    "tcp": ((4, 2, 4, "qwen3-4b", "train_4k"),
            dict(scheduler_host="127.0.0.1", scheduler_port=9191, transport="tcp",
                 mode="dist_sgd", faults="kill@2:unit=1", barrier_timeout=1.5)),
    "tcp-recovery": ((2, 1, 2, "qwen3-4b", "train_4k"),
                     dict(scheduler_host="127.0.0.1", scheduler_port=4242,
                          transport="tcp", mode="dist_esgd", restarts=2,
                          restart_backoff=0.1, checkpoint_every=1,
                          faults="kill@2:unit=1;restart@2:unit=1",
                          server_faults="kill@1:unit=0;restart@1:unit=0",
                          barrier_timeout=120.0,
                          policy=dict(method="multi_ring", num_rings=2, wire_dtype="int8"))),
}


def _specs(name, **port_only):
    """(the reference's spec, the port's) of ``SPECS[name]``; keywords
    only the port's JobSpec has (``device``) go to the port's alone."""
    args, kw = SPECS[name]
    kw = dict(kw)
    pol = kw.pop("policy", None)
    jkw = dict(kw, policy=JPolicy(**pol)) if pol else kw
    tkw = dict(kw, policy=TPolicy(**pol)) if pol else dict(kw)
    return jl.JobSpec(*args, **jkw), tl.JobSpec(*args, **tkw, **port_only)


def _port_job_as_reference(job: dict) -> dict:
    job = json.loads(json.dumps(job))
    assert job["spec"].pop("device") == "cuda"
    return job


@pytest.mark.parametrize("name", sorted(SPECS))
def test_build_job_field_for_field(name):
    jspec, tspec = _specs(name)
    want = json.loads(_sub(json.dumps(jl.build_job(jspec))))
    assert _port_job_as_reference(tl.build_job(tspec)) == want


@pytest.mark.parametrize("name", sorted(SPECS))
def test_emit_scripts_byte_equal(name, tmp_path):
    jspec, tspec = _specs(name)
    jpaths = jl.emit_scripts(jspec, str(tmp_path / "ref"))
    tpaths = tl.emit_scripts(tspec, str(tmp_path / "port"))
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    for jp, tp in zip(jpaths, tpaths):
        want = _sub(open(jp).read().replace(str(tmp_path / "ref"), str(tmp_path / "port")))
        got = open(tp).read()
        if tp.endswith("job_spec.json"):
            assert got.count('    "device": "cuda",\n') == 1
            got = got.replace('    "device": "cuda",\n', "")
        assert got == want, os.path.basename(tp)
        assert os.access(tp, os.X_OK) == os.access(jp, os.X_OK)


@pytest.mark.parametrize("name", ["tcp", "tcp-recovery", "hybrid-knobs"])
def test_parse_script_round_trip(name, tmp_path):
    """Every emitted client / server script parses back to the facts that
    made it, as the port's and the reference's parsers both read it."""
    jspec, tspec = _specs(name)
    paths = tl.emit_scripts(tspec, str(tmp_path))
    job = json.load(open(tmp_path / "job_spec.json"))
    rdzv = f"{tspec.scheduler_host}:{tspec.scheduler_port}"
    scripts = [p for p in paths if p.endswith(".sh")
               and os.path.basename(p) != "launch_all.sh"]
    assert len(scripts) == tspec.num_clients + (tspec.num_servers
                                                if tspec.transport == "tcp" else 0)
    for path in scripts:
        base = os.path.basename(path)
        text = open(path).read()
        for var in ("REPRO_RDZV_ADDR", "REPRO_ROLE", "REPRO_RANK"):
            assert text.count(f"export {var}=") == 1, (base, var)
        got = tl.parse_script(path)
        assert got == jl.parse_script(path)
        role, _, rank = base[:-len(".sh")].rpartition("_")
        assert got["rdzv_addr"] == rdzv and got["rank"] == int(rank)
        assert got["role"] == {"server": "server", "client": "worker"}[role]
        if role == "server":
            assert got["cmd"] == job["servers"][int(rank)]["launch_cmd"]
            assert got["flags"] == {"rank": rank, "rendezvous": rdzv}
            assert "repro_torch.net.kvserver" in got["cmd"]
            continue
        assert got["cmd"] == job["clients"][int(rank)]["launch_cmd"]
        assert "repro_torch.launch.train" in got["cmd"]
        assert got["flags"]["client"] == rank
        if tspec.transport == "tcp":
            assert got["flags"]["transport"] == "tcp"
            assert got["flags"]["mode"] == tspec.mode
            assert got["flags"]["faults"] == tspec.faults
            assert got["flags"]["barrier-timeout"] == f"{tspec.barrier_timeout:g}"
        else:
            assert got["flags"]["optimizer"] == tspec.optimizer
            assert got["flags"]["restore"] == tspec.restore


@pytest.mark.parametrize("name", ["tcp", "hybrid-knobs", "pure-mpi"])
def test_device_threaded_only_when_asked(name, tmp_path):
    _, cuda = _specs(name)
    _, cpu = _specs(name, device="cpu")
    jc, jg = tl.build_job(cuda), tl.build_job(cpu)
    cmds = lambda job: ([c["launch_cmd"] for c in job["clients"]]
                        + [s["launch_cmd"] for s in job["servers"] if "launch_cmd" in s])
    assert not any("--device" in c for c in cmds(jc))
    for c, g in zip(cmds(jc), cmds(jg)):
        assert g == c + " --device cpu"
    assert jg["scheduler"] == jc["scheduler"]
    for path in tl.emit_scripts(cpu, str(tmp_path)):
        if path.endswith(".sh") and "launch_all" not in path:
            assert tl.parse_script(path)["flags"]["device"] == "cpu"


BAD_SPECS = [
    ((5, 2, 2, "a", "s"), {}),
    ((4, 0, 2, "a", "s"), {}),
    ((4, -1, 1, "a", "s"), {}),
    ((4, 2, 2, "a", "s"), dict(optimizer="lamb")),
    ((4, 2, 2, "a", "s"), dict(state_dtype="f16")),
    ((4, 2, 2, "a", "s"), dict(overlap=True, fused_update=False)),
    ((4, 2, 2, "a", "s"), dict(wire_dtype="int4")),
    ((4, 2, 2, "a", "s"), dict(allreduce_method="psum", wire_dtype="int8")),
    ((4, 2, 2, "a", "s"), dict(faults="kill@2:unit=1")),
    ((4, 2, 2, "a", "s"), dict(faults="explode@2")),
    ((4, 2, 2, "a", "s"), dict(barrier_timeout=-1.0)),
    ((4, 2, 4, "a", "s"), dict(transport="tcp")),
    ((4, 2, 2, "a", "s"), dict(transport="tcp", mode="dist_sgd")),
    ((4, 0, 1, "a", "s"), dict(transport="tcp", mode="dist_sgd")),
    ((4, 2, 2, "a", "s"), dict(transport="carrier-pigeon")),
    ((4, 2, 4, "a", "s"), dict(transport="tcp", mode="mpi_sgd")),
    ((2, 1, 2, "q", "t"), dict(mode="dist_sgd", barrier_timeout=1.0, restarts=1)),
    ((2, 1, 2, "q", "t"), dict(mode="dist_sgd", barrier_timeout=1.0,
                               faults="kill@2:unit=1;restart@2:unit=1")),
    ((2, 1, 2, "q", "t"), dict(mode="dist_sgd", barrier_timeout=1.0,
                               server_faults="kill@1:unit=0")),
    ((2, 1, 2, "q", "t"), dict(mode="dist_sgd", transport="tcp", barrier_timeout=1.0,
                               server_faults="kill@1:unit=0;restart@1:unit=0")),
    ((2, 1, 2, "q", "t"), dict(mode="dist_sgd", transport="tcp", restarts=-1)),
    ((2, 1, 2, "q", "t"), dict(mode="dist_sgd", transport="tcp", restart_backoff=-0.1)),
    ((2, 1, 2, "q", "t"), dict(mode="dist_sgd", transport="tcp", checkpoint_every=-1)),
]


@pytest.mark.parametrize("args,kw", BAD_SPECS,
                         ids=[f"bad{i}" for i in range(len(BAD_SPECS))])
def test_job_spec_validation_messages_equal(args, kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError) as want:
            jl.build_job(jl.JobSpec(*args, **kw))
        with pytest.raises(ValueError) as got:
            tl.build_job(tl.JobSpec(*args, **kw))
    assert str(got.value) == str(want.value)


def test_job_spec_policy_backfill_equal():
    """The flat mirrors and the one policy field resolve alike, through
    construction and ``dataclasses.replace``."""
    import dataclasses

    for kw in (dict(), dict(wire_dtype="int8"), dict(overlap=True),
               dict(allreduce_method="tree"), dict(num_rings=3, bucket_bytes=4096)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            j = jl.JobSpec(8, 2, 2, "a", "s", **kw)
            t = tl.JobSpec(8, 2, 2, "a", "s", **kw)
            assert t.policy.to_dict() == j.policy.to_dict()
            j2 = dataclasses.replace(j, overlap=not j.overlap)
            t2 = dataclasses.replace(t, overlap=not t.overlap)
        assert t2.policy.to_dict() == j2.policy.to_dict()
        assert t2.allreduce_method == j2.allreduce_method


def test_jobspec_recovery_fields_validate_and_thread():
    _, spec = _specs("tcp-recovery")
    spec.validate()
    rec = tl.build_job(spec)["recovery"]
    assert rec["restarts"] == 2 and rec["checkpoint_every"] == 1
    assert rec["server_faults"] == "kill@1:unit=0;restart@1:unit=0"


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-0.5b", "--workers", "8", "--servers", "0", "--clients", "1",
     "--policy", "auto"],
    ["--arch", "qwen3-4b", "--workers", "8", "--servers", "2", "--clients", "2",
     "--policy", "auto"],
    ["--workers", "4", "--servers", "1", "--clients", "2", "--wire-dtype", "bf16",
     "--allreduce", "multi_ring", "--num-rings", "4", "--overlap-buckets", "2"],
], ids=["pure-mpi-auto", "hybrid-auto", "flat-flags"])
def test_launcher_main_equal(argv, tmp_path, monkeypatch, capsys):
    """Both launchers' ``main`` on the same flags emit the same scripts
    (the port's rates set to the reference's for ``--policy auto``)."""
    ref_net = tcost.NetParams(**vars(jcost.tpu_v5e()))
    monkeypatch.setattr(tcost, "testbed", lambda: ref_net)
    monkeypatch.setitem(ttune.autotune_for_model.__kwdefaults__, "peak_flops",
                        janalysis.PEAK_FLOPS)
    monkeypatch.setattr(sys, "argv", ["launcher"] + argv + ["--outdir", str(tmp_path / "ref")])
    jl.main()
    want_out = capsys.readouterr().out
    paths = tl.main(argv + ["--outdir", str(tmp_path / "port")])
    got_out = capsys.readouterr().out
    assert got_out == want_out.replace(str(tmp_path / "ref"), str(tmp_path / "port"))
    for path in paths:
        name = os.path.basename(path)
        got = open(path).read().replace('    "device": "cuda",\n', "")
        want = _sub(open(tmp_path / "ref" / name).read()).replace(
            str(tmp_path / "ref"), str(tmp_path / "port"))
        assert got == want, name
    if "auto" in argv:
        assert "# --policy auto:" in got_out and "| # | method" in got_out


# --- the supervisor ladder (fake processes, an injected clock) -----------------

class _FakeProc:
    """poll() walks a scripted exit-code sequence; None = still running."""

    def __init__(self, codes):
        self.codes = list(codes)

    def poll(self):
        return self.codes.pop(0) if self.codes else None


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.01
        return t[0]

    return clock


def test_supervisor_scheduled_respawn_spares_budget():
    slept, spawned, stashed = [], [], []

    def spawn(u):
        spawned.append(u.attempt)
        return _FakeProc([0])

    sup = Supervisor(spawn, policy=RestartPolicy(max_restarts=0),
                     worker_injector=injector("kill@2:unit=1;restart@2:unit=1:delay=0.25"),
                     on_respawn=lambda u: stashed.append((u.name, u.attempt)),
                     clock=_fake_clock(), sleep=slept.append)
    sup.register("client_1", _FakeProc([137]), role="worker", unit=1)
    report = sup.supervise(timeout=60.0)
    assert report["respawns"][0]["scheduled"] and report["respawns"][0]["exit_code"] == 137
    assert 0.25 in slept
    assert sup.units["client_1"].used_budget == 0
    assert report["exhausted"] == [] and report["gave_up"] == []
    assert report["exit_history"]["client_1"] == [137, 0]
    assert spawned == [1] and stashed == [("client_1", 0)]
    assert report["exit_codes"] == {"client_1": 0} and not report["timed_out"]


def test_supervisor_budget_exhaustion_fails_loudly():
    sup = Supervisor(lambda u: _FakeProc([137]),
                     policy=RestartPolicy(max_restarts=1, backoff=0.0),
                     clock=_fake_clock(), sleep=lambda s: None)
    sup.register("client_1", _FakeProc([137]), role="worker", unit=1)
    sup.register("client_0", _FakeProc([0]), role="worker", unit=0)
    report = sup.supervise(timeout=60.0)
    assert report["exhausted"] == ["client_1"] and report["gave_up"] == ["client_1"]
    assert report["exit_history"] == {"client_1": [137, 137], "client_0": [0]}
    assert sup.units["client_1"].used_budget == 1
    assert len(report["respawns"]) == 1 and not report["respawns"][0]["scheduled"]


def test_supervisor_no_budget_keeps_quiet_eviction():
    sup = Supervisor(lambda u: _FakeProc([0]), policy=RestartPolicy(),
                     clock=_fake_clock(), sleep=lambda s: None)
    sup.register("client_1", _FakeProc([137]), role="worker", unit=1)
    sup.register("client_0", _FakeProc([0]), role="worker", unit=0)
    report = sup.supervise(timeout=60.0)
    assert report["gave_up"] == ["client_1"]
    assert report["exhausted"] == [] and report["respawns"] == []


def test_supervisor_backoff_grows_exponentially():
    pol = RestartPolicy(max_restarts=5, backoff=0.1, backoff_factor=2.0, max_backoff=0.5)
    assert [pol.delay(k) for k in range(5)] == [0.1, 0.2, 0.4, 0.5, 0.5]
    jpol = jsup.RestartPolicy(max_restarts=5, backoff=0.1, backoff_factor=2.0,
                              max_backoff=0.5)
    assert [pol.delay(k) for k in range(7)] == [jpol.delay(k) for k in range(7)]


def test_supervisor_budget_backoff_sleeps_are_the_policys():
    slept = []
    sup = Supervisor(lambda u: _FakeProc([137]),
                     policy=RestartPolicy(max_restarts=3, backoff=0.1, max_backoff=0.3),
                     clock=_fake_clock(), sleep=slept.append, poll_interval=0.0)
    sup.register("client_0", _FakeProc([137]), role="worker", unit=0)
    report = sup.supervise(timeout=60.0)
    assert [s for s in slept if s] == [0.1, 0.2, 0.3]
    assert report["attempts"]["client_0"] == 3 and report["exhausted"] == ["client_0"]


def test_supervisor_respawned_server_is_not_waited_on():
    server_spawns = []

    def spawn(u):
        server_spawns.append(u.name)
        return _FakeProc([])

    sup = Supervisor(spawn, policy=RestartPolicy(),
                     server_injector=injector("kill@1:unit=0;restart@1:unit=0"),
                     clock=_fake_clock(), sleep=lambda s: None)
    sup.register("server_0", _FakeProc([137]), role="server", unit=0)
    sup.register("client_0", _FakeProc([None, None, 0]), role="worker", unit=0)
    report = sup.supervise(timeout=60.0)
    assert server_spawns == ["server_0"]
    assert report["attempts"]["server_0"] == 1 and not report["timed_out"]
    assert report["respawns"][0]["role"] == "server"


def test_supervisor_times_out_on_the_injected_clock():
    sup = Supervisor(lambda u: _FakeProc([]), clock=_fake_clock(), sleep=lambda s: None)
    sup.register("client_0", _FakeProc([]), role="worker", unit=0)
    report = sup.supervise(timeout=1.0)
    assert report["timed_out"] and report["exit_codes"] == {"client_0": None}


def test_supervisor_rejects_unknown_role_and_carries_partial_result():
    sup = Supervisor(lambda u: None)
    with pytest.raises(ValueError, match="role must be worker/server"):
        sup.register("x", None, role="scheduler")
    err = JobFailed("budget gone", result={"losses": [1.0]})
    assert err.result == {"losses": [1.0]} and str(err) == "budget gone"
    u = Unit(name="client_0", role="worker", unit=0, proc=None)
    assert u.attempt == 0 and not u.exhausted and u.exit_codes == []


# --- run_local's merge of spawn generations ------------------------------------

def test_merge_worker_records_later_generation_wins():
    pre = {"gsteps": [0, 1, 2], "losses": [1.0, 0.9, 0.8], "metric_epochs": [0],
           "metrics": [0.5]}
    post = {"gsteps": [2, 3], "losses": [0.79, 0.7], "metric_epochs": [0],
            "metrics": [0.6], "rank": 1}
    out = trl._merge_worker_records([pre, post])
    assert out == jrl._merge_worker_records([pre, post])
    assert out["gsteps"] == [0, 1, 2, 3] and out["losses"] == [1.0, 0.9, 0.79, 0.7]
    assert out["metrics"] == [0.6] and out["pieces"] == 2 and out["rank"] == 1
    legacy = [{"gsteps": [0], "losses": [2.0], "metrics": [0.1, 0.2]},
              {"gsteps": [1], "losses": [1.0], "metrics": [0.3]}]
    assert trl._merge_worker_records(legacy) == jrl._merge_worker_records(legacy)


def test_collect_worker_metrics_orders_stashes_and_skips_torn(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "metrics_worker_0.pre0.json"), "w") as f:
        json.dump({"gsteps": [0], "losses": [1.0], "metrics": []}, f)
    with open(os.path.join(d, "metrics_worker_0.pre1.json"), "w") as f:
        f.write('{"gsteps": [1], "lo')
    with open(os.path.join(d, "metrics_worker_0.preX.json"), "w") as f:
        f.write("{}")
    with open(os.path.join(d, "metrics_worker_0.json"), "w") as f:
        json.dump({"gsteps": [1, 2], "losses": [0.9, 0.8], "metrics": []}, f)
    with open(os.path.join(d, "metrics_worker_1.pre0.json"), "w") as f:
        json.dump({"gsteps": [0], "losses": [3.0], "metrics": [0.2]}, f)
    out = trl._collect_worker_metrics(d, num_workers=3)
    assert out == jrl._collect_worker_metrics(d, num_workers=3)
    assert out[0]["losses"] == [1.0, 0.9, 0.8] and out[0]["pieces"] == 2
    assert out[1]["losses"] == [3.0] and 2 not in out
    assert trl._collect_worker_metrics(str(tmp_path / "missing"), 2) == {}


def test_aggregate_and_fold_server_stats_equal():
    recs = {1: {"gsteps": [0, 1], "losses": [2.0, 1.0], "metrics": [0.5]},
            0: {"gsteps": [0, 1, 2], "losses": [3.0, 2.0, 1.5], "metrics": []}}
    stats = {0: {"degraded_syncs": 2, "late_pushes": 1, "membership_epoch": 3,
                 "live": [0]},
             1: {"degraded_syncs": 1, "membership_epoch": 1, "live": [0, 1]}}
    got, want = trl.JobResult(transport="tcp"), jrl.JobResult(transport="tcp")
    trl._aggregate(got, recs)
    jrl._aggregate(want, recs)
    trl._fold_server_stats(got, stats)
    jrl._fold_server_stats(want, stats)
    assert vars(got) == vars(want)
    assert got.losses == [2.5, 1.5, 1.5] and got.metrics == [0.5]
    assert got.degraded_syncs == 3 and got.membership_epochs == 3 and got.live == [0]


def test_make_spec_threads_the_job(monkeypatch):
    from repro_torch.core.algorithms import AlgoConfig
    from repro.core.algorithms import AlgoConfig as JAlgo

    kw = dict(mode="dist_sgd", num_workers=2, num_clients=2, num_servers=1,
              epochs=1, steps_per_epoch=3, seed=0, checkpoint_every=1,
              faults="kill@2:unit=1;restart@2:unit=1", barrier_timeout=120.0,
              server_faults="kill@1:unit=0;restart@1:unit=0", restarts=1)
    t = trl._make_spec(AlgoConfig(**kw), transport="tcp", port=5000, device="cpu")
    j = jrl._make_spec(JAlgo(**kw), transport="tcp", port=5000)
    assert t.device == "cpu"
    want = json.loads(_sub(json.dumps(jl.build_job(j))))
    got = json.loads(json.dumps(tl.build_job(t)))
    assert got["spec"].pop("device") == "cpu"
    for c in got["clients"]:
        c["launch_cmd"] = c["launch_cmd"].removesuffix(" --device cpu")
    for s in got["servers"]:
        s["launch_cmd"] = s["launch_cmd"].removesuffix(" --device cpu")
    assert got == want


def test_run_local_cli_loopback(capsys):
    """``python -m repro_torch.launch.run_local``'s flags lowered into an
    AlgoConfig, run as loopback threads on the CPU, summarized as JSON."""
    trl.main(["--device", "cpu", "--transport", "loopback", "--mode", "dist_sgd",
              "--workers", "2", "--servers", "1", "--steps", "2", "--wire-dtype", "int8"])
    out = json.loads(capsys.readouterr().out)
    assert out["transport"] == "loopback" and out["device"] == "cpu"
    assert len(out["losses"]) == 2 and out["exit_codes"] == {"client_0": 0, "client_1": 0}
    assert out["live"] == [0, 1] and out["respawns"] == 0
