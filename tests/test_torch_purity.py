"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX, ml_dtypes nor the reference package, at run time or in their
source (a socket PS job on the loopback transport included),
and the chip smoke refuses to report without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

STEP = """
import sys
import torch
torch.set_num_threads(2)
from repro_torch.configs.base import TrainSettings, get_config, reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.train import make_grad_fn, make_train_state, make_train_step
from repro_torch.models.model import build_model
from repro_torch import bridge, tree
from repro_torch.checkpoint import checkpoint
from repro_torch.core import (algorithms, client, collectives, comm, cost_model,
                              elastic, flatbuf, hierarchy, kvstore, scheduler,
                              sync_engine)
from repro_torch.kernels import common
from repro_torch.kernels.fused_elastic import fused_elastic
from repro_torch.kernels.fused_optim import fused_optim
from repro_torch.kernels.fused_sgd import fused_sgd
from repro_torch.kernels.quant_bucket import quant_bucket
from repro_torch.launch import (analysis, autotune, launcher, run_local, serve,
                                shard_driver, supervisor)
from repro_torch.net import kvserver, problem, remote_kv, rendezvous, transport, wire, worker
from repro_torch.optim import sgd
model = build_model(reduced(get_config("qwen2-0.5b")))
srv = serve.BatchedServer(model, model.init(device="cpu"), batch=2, max_seq=8, device="cpu")
assert tuple(srv.generate(torch.tensor([[1, 2], [3, 4]], dtype=torch.int32), 3).shape) == (2, 3)
s = TrainSettings(optimizer_name="adamw", lr=1e-3)
state = make_train_state(model, s.optimizer(), s.sync_config(), device="cpu")
step = make_train_step(model, s.optimizer(), s.sync_config(), device="cpu")
batch = TokenPipeline(DataConfig(vocab_size=256, seq_len=16, batch_size=2)).batch_at(0, 0)
state, met = step(state, batch)
assert torch.isfinite(met["loss"])
esgd = hierarchy.SyncConfig(mode="mpi_esgd", num_clients=2, esgd_interval=1,
                            policy=comm.CollectivePolicy(method="ring", wire_dtype="int8"))
opt = sgd.sgd(0.1, 0.9)
dstate = shard_driver.make_driver_state(model, opt, esgd, (2, 2), device="cpu")
dstep = shard_driver.make_emulated_step(model, opt, esgd, (2, 2))
batch4 = TokenPipeline(DataConfig(vocab_size=256, seq_len=16, batch_size=4)).batch_at(0, 0)
dstate, met = dstep(dstate, shard_driver.shard_batch(batch4, (2, 2)))
assert torch.isfinite(met["loss"])
grad = make_grad_fn(model)
data = dict(vocab_size=256, seq_len=16, batch_size=2, steps_per_epoch=1)
cfg = algorithms.AlgoConfig(mode="mpi_esgd", num_workers=2, num_clients=1,
                            epochs=1, steps_per_epoch=1, esgd_interval=1,
                            policy=comm.CollectivePolicy(method="multi_ring",
                                                         num_rings=2, wire_dtype="int8"))
hist = algorithms.run(cfg, lambda gen: model.init(device="cpu"),
                      lambda p, b: (lambda o: (o[0], o[2]))(grad(p, b)),
                      lambda p: 0.0,
                      lambda w: TokenPipeline(DataConfig(**data, shard=w)),
                      device="cpu")
assert hist.pushed_bytes > 0 and len(hist.losses) == 1
ncfg = algorithms.AlgoConfig(mode="dist_sgd", num_workers=1, num_clients=1,
                             num_servers=1, epochs=1, steps_per_epoch=2,
                             policy=comm.CollectivePolicy(wire_dtype="int8"))
tr = transport.transport_for("loopback")
rdzv = rendezvous.Rendezvous(num_workers=1, num_servers=1, num_clients=1,
                             algo=rendezvous.algo_to_dict(ncfg), transport="loopback")
rsrv = tr.serve(rdzv.handle)
ksrv = tr.serve(kvserver.KVServer(ncfg, device="cpu").handle)
rendezvous.join_rendezvous(tr.connect(rsrv.addr), "server", 0, addr=ksrv.addr)
out = worker.run_worker(rank=0, rendezvous_addr=rsrv.addr, transport="loopback",
                        device="cpu")
assert len(out["losses"]) == 2 and out["kv"]["pushed_bytes"] > 0
tuned = autotune.autotune_for_model(reduced(get_config("qwen2-0.5b")), p=8,
                                    tokens_per_step=1 << 20)
assert tuned.ranked and analysis.parse_collectives("").total_ops() == 0
import tempfile
spec = launcher.JobSpec(2, 1, 2, "qwen2-0.5b", "train_4k", transport="tcp",
                        mode="dist_sgd", device="cpu", policy=tuned.chosen.policy)
assert len(launcher.emit_scripts(spec, tempfile.mkdtemp())) == 5
assert supervisor.RestartPolicy(max_restarts=1).delay(0) == 0.05
job = run_local.run_job(ncfg, transport="loopback", device="cpu")
assert len(job.losses) == 2 and job.exit_codes == {"client_0": 0}
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro", "ml_dtypes")
             or m.startswith(("jax.", "repro.", "ml_dtypes.")))
print("BAD", bad)
"""


def test_port_runs_a_step_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", STEP], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_mesh.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path}: imports {name}"


#: the reference's TPU v5e rates (``repro/launch/analysis.py``,
#: ``repro/core/cost_model.tpu_v5e``): none may reach the launch tier
TPU_RATES = (197e12, 819e9, 50e9)
LAUNCH_TIER = ("analysis", "autotune", "supervisor", "launcher", "run_local")


@pytest.mark.parametrize("name", LAUNCH_TIER)
def test_launch_tier_carries_no_tpu_rate(name):
    path = PORT / "launch" / f"{name}.py"
    text = path.read_text()
    consts = {node.value for node in ast.walk(ast.parse(text))
              if isinstance(node, ast.Constant) and isinstance(node.value, (int, float))}
    assert not consts & set(TPU_RATES), f"{path}: {sorted(consts & set(TPU_RATES))}"
    for literal in ("197e12", "819e9", "50e9", "tpu_v5e", "ICI_BW"):
        assert literal not in text, f"{path}: {literal}"
    assert not {"jax", "jaxlib", "repro"} & {n.split(".")[0] for n in _imports(path)}


def test_process_mesh_ranks_import_no_jax_or_reference():
    """Two gloo ranks of the process mesh (``spawn_ranks``) take a
    ``drive(mesh=)`` step of the reduced model; neither they nor their
    parent import JAX or the reference."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    code = (
        "import sys\n"
        "import _torch_mesh as TM\n"
        "from repro_torch.launch.mesh import spawn_ranks\n"
        "if __name__ == '__main__':\n"
        "    bad = spawn_ranks(TM.purity_rank, (2,), ('dev',), backend='gloo', device='cpu')\n"
        "    bad.append(sorted(m for m in sys.modules if m.split('.')[0] in TM.FOREIGN))\n"
        "    print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD [[], [], []]" in out.stdout, out.stdout


def test_run_local_children_import_no_jax_or_reference(tmp_path):
    """The emitted worker and server processes of a tcp job import
    neither JAX nor the reference: their scripts' environment carries the
    port's ``src`` only, and a job on the CPU runs to its end."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (
        "import sys\n"
        "from repro_torch.core.algorithms import AlgoConfig\n"
        "from repro_torch.launch import run_local\n"
        "cfg = AlgoConfig(mode='dist_sgd', num_workers=1, num_clients=1, num_servers=1,\n"
        "                 epochs=1, steps_per_epoch=2, seed=0)\n"
        f"res = run_local.run_job(cfg, device='cpu', outdir={str(tmp_path)!r})\n"
        "assert res.exit_codes == {'server_0': 0, 'client_0': 0}, res.exit_codes\n"
        "env = run_local._child_env(res.outdir)\n"
        "assert env.get('JAX_PLATFORMS') == __import__('os').environ.get('JAX_PLATFORMS')\n"
        "print('BAD', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
    for log in ("client_0.log", "server_0.log"):
        text = (tmp_path / log).read_text()
        assert "Traceback" not in text and "jax" not in text, text[-2000:]
    assert "transport worker 0 done: 2 steps" in (tmp_path / "client_0.log").read_text()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device: non-zero exit and no result line. Alone in a
    directory (no port beside it): the same."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    runs = [(ROOT, ROOT / "chip_smoke.py")]
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs.append((tmp_path, lone))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
