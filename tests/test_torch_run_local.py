"""``repro_torch.launch.run_local.run_job`` with REAL OS processes on the
CPU (``device="cpu"``): the emitted scripts spawned under the supervisor,
TCP on 127.0.0.1, logreg8 at 3 steps.

- dist_sgd over tcp ``==`` the same job as loopback threads ``==`` the
  port's in-process ``algorithms.run`` (per-step mean loss, metrics);
- a worker SIGKILLed by its schedule and respawned: the merged curve
  ``==`` the clean job, exit history [137, 0], no degraded release;
- two kills against a budget of one: ``JobFailed`` with [137, 137];
- the server killed right after it snapshots step 1 and restored: every
  round lands, the curve ``==`` the clean job, restored step >= 1.

No result waits on a wall clock: the barrier timeout of the faulted jobs
is a 120 s deadlock guard (the respawn rejoins within seconds), and the
exhaustion job has one worker, so no survivor waits at a barrier. This
process and every child compute on one CPU thread (``_torch_net.one_thread``),
as the exact holds need.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_net import one_thread  # noqa: E402
from repro_torch.core import algorithms as TA  # noqa: E402
from repro_torch.launch.run_local import run_job  # noqa: E402
from repro_torch.launch.supervisor import JobFailed  # noqa: E402
from repro_torch.net.problem import build_problem  # noqa: E402

GUARD_S = 120.0
BASE = dict(mode="dist_sgd", num_workers=2, num_clients=2, num_servers=1,
            lr=0.05, epochs=1, steps_per_epoch=3, seed=0, compute_time=0.0,
            jitter=0.0)


def _algo(**kw):
    return TA.AlgoConfig(**dict(BASE, **kw))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def clean(_one_thread):
    return run_job(_algo(), transport="tcp", device="cpu", timeout=240.0)


def test_tcp_equals_loopback_equals_inprocess(clean):
    prob = build_problem("logreg8", device="cpu")
    hist = TA.run(_algo(), prob.init_fn, prob.grad_fn, prob.eval_fn,
                  prob.make_pipeline, device="cpu")
    loop = run_job(_algo(), transport="loopback", device="cpu")
    assert len(clean.losses) == 3
    assert clean.losses == loop.losses == hist.losses
    assert clean.metrics == loop.metrics == hist.metrics
    assert clean.exit_codes == {"server_0": 0, "client_0": 0, "client_1": 0}
    assert loop.exit_codes == {"client_0": 0, "client_1": 0}
    assert clean.degraded_syncs == loop.degraded_syncs == 0
    assert clean.live == loop.live == [0, 1]
    assert clean.respawns == [] and clean.exhausted == []
    assert [p.rsplit("/", 1)[1] for p in clean.script_paths] == [
        "job_spec.json", "server_0.sh", "client_0.sh", "client_1.sh", "launch_all.sh"]


def test_kill_respawn_is_bit_identical(clean, tmp_path):
    res = run_job(_algo(faults="kill@2:unit=1;restart@2:unit=1", checkpoint_every=1,
                        barrier_timeout=GUARD_S),
                  transport="tcp", device="cpu", outdir=str(tmp_path), timeout=240.0)
    assert res.losses == clean.losses
    assert res.metrics == clean.metrics
    assert res.degraded_syncs == 0
    assert res.exit_history["client_1"] == [137, 0]
    assert res.exit_history["client_0"] == [0]
    assert len(res.respawns) == 1 and res.respawns[0]["scheduled"]
    assert res.attempts["client_1"] == 1 and res.per_worker[1]["pieces"] == 2


def test_budget_exhaustion_raises_jobfailed(tmp_path):
    with pytest.raises(JobFailed, match="client_0") as ei:
        run_job(_algo(num_workers=1, num_clients=1, steps_per_epoch=4, restarts=1,
                      faults="kill@1:unit=0;kill@2:unit=0", checkpoint_every=1,
                      barrier_timeout=GUARD_S),
                transport="tcp", device="cpu", outdir=str(tmp_path), timeout=240.0)
    assert "137" in str(ei.value)
    res = ei.value.result
    assert res.exit_history["client_0"] == [137, 137]
    assert res.exhausted == ["client_0"]
    assert len(res.respawns) == 1 and not res.respawns[0]["scheduled"]


def test_server_kill_restores_with_zero_lost_rounds(clean, tmp_path):
    res = run_job(_algo(server_faults="kill@1:unit=0;restart@1:unit=0",
                        checkpoint_every=1, barrier_timeout=GUARD_S),
                  transport="tcp", device="cpu", outdir=str(tmp_path), timeout=240.0)
    assert res.losses == clean.losses
    assert res.metrics == clean.metrics
    assert res.degraded_syncs == 0
    assert len(res.respawns) == 1 and res.respawns[0]["role"] == "server"
    assert res.exit_history["server_0"][0] == 137
    st = res.server_stats[0]
    assert st["restored_from"] and st["restored_step"] >= 1 and st["attempt"] == 1
