"""Run a transport job as REAL OS processes on localhost
(``repro/launch/run_local.py``).

``run_job(algo)`` is the multi-process twin of ``algorithms.run(cfg)``:

  tcp       builds the JobSpec, ``emit_scripts`` materializes one shell
            script per server and per worker, and each script is spawned
            with ``/bin/sh`` as its own OS process under the
            ``Supervisor`` — the processes find each other through a
            rendezvous this process serves at the spec's scheduler
            address, as a cluster scheduler would run the emitted
            scripts. Worker metrics come back through
            ``outdir/metrics_worker_<rank>.json``.
  loopback  the same rendezvous / KVServer / worker code paths on the
            loopback transport (threads, no sockets): the in-process
            reference the tcp curves are held against.

Every process and thread runs on ``device`` (the card unless the caller
passes ``device="cpu"``): the spec threads it to the scripts' ``--device``
flag, so each child opens its own CUDA context.

The aggregated ``JobResult`` mirrors algorithms.History where it can
(per-step mean worker loss in client order, per-epoch metrics) and adds
the transport-side accounting (exit codes, server stats, socket bytes).

Crash recovery: an abnormal exit respawns the unit (schedule- or
budget-driven) with REPRO_ATTEMPT bumped, the dying generation's partial
``metrics_worker_<rank>.json`` is stashed as ``.pre<attempt>.json``, and
``_collect_worker_metrics`` merges every generation's curve by global
step (the respawn replays from its parked PS state, so the merged
dist_sgd curve is bit-identical to the fault-free run). A spent restart
budget raises ``JobFailed`` carrying the partial JobResult and the full
per-unit exit-code history.

  python -m repro_torch.launch.run_local --device cpu --mode dist_sgd \
      --workers 2 --servers 1 --steps 3
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class JobResult:
    transport: str
    losses: list = field(default_factory=list)    # per-step mean over workers
    metrics: list = field(default_factory=list)   # per-epoch (worker 0)
    final_loss: Optional[float] = None
    per_worker: dict = field(default_factory=dict)
    server_stats: dict = field(default_factory=dict)
    exit_codes: dict = field(default_factory=dict)
    degraded_syncs: int = 0
    late_pushes: int = 0
    membership_epochs: int = 0
    live: list = field(default_factory=list)
    script_paths: list = field(default_factory=list)
    outdir: str = ""
    # supervision accounting (tcp): one record per respawn (unit,
    # attempt, exit_code, scheduled?, wall-clock gap), final attempt
    # numbers, exit-code history, and the units whose budget ran out
    respawns: list = field(default_factory=list)
    attempts: dict = field(default_factory=dict)
    exit_history: dict = field(default_factory=dict)
    exhausted: list = field(default_factory=list)


def free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_spec(algo, *, transport: str, port: int, device: str = "cuda"):
    from repro_torch.core.faults import as_schedule
    from repro_torch.launch.launcher import JobSpec

    sched = as_schedule(algo.faults, seed=algo.seed)
    server_sched = as_schedule(getattr(algo, "server_faults", None),
                               seed=algo.seed)
    return JobSpec(
        algo.num_workers, algo.num_servers, algo.effective_clients,
        "qwen3-4b", "train_4k",
        scheduler_host="127.0.0.1", scheduler_port=port,
        faults=sched.format() if sched is not None else "",
        barrier_timeout=algo.barrier_timeout or 0.0,
        restarts=getattr(algo, "restarts", 0),
        restart_backoff=getattr(algo, "restart_backoff", 0.05),
        checkpoint_every=getattr(algo, "checkpoint_every", 0),
        server_faults=(server_sched.format()
                       if server_sched is not None else ""),
        transport=transport, mode=algo.mode, device=device,
        policy=algo.policy)


def _aggregate(result: JobResult, worker_out: dict[int, dict]) -> None:
    """History-shaped curves from per-worker records: per-step mean loss
    over the workers that computed that step (client order), worker 0's
    per-epoch metrics (every replica's params are identical on clean
    sync runs, so the choice only matters after a kill)."""
    result.per_worker = worker_out
    by_step: dict[int, list] = {}
    for rank in sorted(worker_out):
        rec = worker_out[rank]
        for gstep, loss in zip(rec.get("gsteps", []),
                               rec.get("losses", [])):
            by_step.setdefault(int(gstep), []).append(loss)
    result.losses = [float(np.mean(by_step[s])) for s in sorted(by_step)]
    for rank in sorted(worker_out):
        if worker_out[rank].get("metrics"):
            result.metrics = [float(m)
                              for m in worker_out[rank]["metrics"]]
            break
    if result.losses:
        result.final_loss = result.losses[-1]


def _merge_worker_records(recs: list[dict]) -> dict:
    """Fold one worker's metric pieces (pre-kill partials stashed by the
    supervisor, oldest first, then the final record) into one curve:
    losses merge by global step and per-epoch metrics by epoch, with the
    LATER generation winning ties — a replayed step recomputes the same
    loss on the sync path, so ties only differ after esgd drift."""
    by_step: dict[int, float] = {}
    by_epoch: dict[int, float] = {}
    for rec in recs:
        for g, loss in zip(rec.get("gsteps", []), rec.get("losses", [])):
            by_step[int(g)] = float(loss)
        epochs = rec.get("metric_epochs")
        metrics = rec.get("metrics", [])
        if epochs is None:
            epochs = list(range(len(metrics)))
        for e, m in zip(epochs, metrics):
            by_epoch[int(e)] = float(m)
    out = dict(recs[-1])
    out["gsteps"] = sorted(by_step)
    out["losses"] = [by_step[g] for g in out["gsteps"]]
    out["metric_epochs"] = sorted(by_epoch)
    out["metrics"] = [by_epoch[e] for e in out["metric_epochs"]]
    out["pieces"] = len(recs)
    return out


def _collect_worker_metrics(outdir: str, num_workers: int) -> dict[int, dict]:
    """Read every generation's metrics file per worker and merge."""
    worker_out: dict[int, dict] = {}
    names = set(os.listdir(outdir)) if os.path.isdir(outdir) else set()
    for rank in range(num_workers):
        prefix = f"metrics_worker_{rank}.pre"
        stashed = []
        for name in names:
            if name.startswith(prefix) and name.endswith(".json"):
                try:
                    stashed.append(
                        (int(name[len(prefix):-len(".json")]), name))
                except ValueError:
                    continue
        paths = [os.path.join(outdir, n) for _, n in sorted(stashed)]
        final = os.path.join(outdir, f"metrics_worker_{rank}.json")
        if os.path.exists(final):
            paths.append(final)
        recs = []
        for path in paths:
            try:
                with open(path) as f:
                    recs.append(json.load(f))
            except (OSError, ValueError):
                continue            # torn partial flush: skip the piece
        if recs:
            worker_out[rank] = _merge_worker_records(recs)
    return worker_out


def _fold_server_stats(result: JobResult, stats: dict[int, dict]) -> None:
    result.server_stats = stats
    for st in stats.values():
        result.degraded_syncs += int(st.get("degraded_syncs", 0))
        result.late_pushes += int(st.get("late_pushes", 0))
        if int(st.get("membership_epoch", 0)) >= result.membership_epochs:
            result.membership_epochs = int(st.get("membership_epoch", 0))
            result.live = list(st.get("live", []))


def run_job(algo, *, transport: str = "tcp", problem: str = "logreg8",
            outdir: Optional[str] = None, timeout: float = 240.0,
            keep_servers: bool = False, device: str = "cuda") -> JobResult:
    """Run ``algo`` (an ``AlgoConfig`` of mode dist_sgd / dist_esgd) as
    worker and server processes (``tcp``) or threads (``loopback``) on
    ``device``; a CUDA request with no CUDA device raises."""
    from repro_torch.launch.train import resolve_device

    device = str(resolve_device(device))
    if transport == "tcp":
        return _run_tcp(algo, problem=problem, outdir=outdir,
                        timeout=timeout, device=device)
    if transport == "loopback":
        return _run_loopback(algo, problem=problem, timeout=timeout,
                             keep_servers=keep_servers, device=device)
    raise ValueError(f"transport must be tcp/loopback, got {transport!r}")


# ---------------------------------------------------------------------------
# tcp: real processes from emitted scripts
# ---------------------------------------------------------------------------

def _child_env(outdir: str) -> dict:
    """The scripts' environment: this package's ``src`` first on
    PYTHONPATH, and ``python`` on PATH resolving to this interpreter (a
    one-line shim in ``outdir/bin``), so the emitted ``python -m ...``
    commands run where this process runs even on a machine whose PATH
    has no ``python`` or another one."""
    import repro_torch

    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    bindir = os.path.join(outdir, "bin")
    os.makedirs(bindir, exist_ok=True)
    shim = os.path.join(bindir, "python")
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(shim, 0o755)
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["PATH"] = bindir + os.pathsep + env.get("PATH", "")
    return env


def _run_tcp(algo, *, problem: str, outdir: Optional[str],
             timeout: float, device: str) -> JobResult:
    from repro_torch.core.faults import injector
    from repro_torch.launch.launcher import emit_scripts
    from repro_torch.launch.supervisor import (JobFailed, RestartPolicy,
                                               Supervisor)
    from repro_torch.net.rendezvous import Rendezvous, algo_to_dict
    from repro_torch.net.transport import TcpTransport

    outdir = outdir or tempfile.mkdtemp(prefix="repro_tcp_")
    os.makedirs(outdir, exist_ok=True)
    port = free_port()
    spec = _make_spec(algo, transport="tcp", port=port, device=device)
    paths = emit_scripts(spec, outdir)
    result = JobResult(transport="tcp", script_paths=paths, outdir=outdir)

    rdzv = Rendezvous(
        num_workers=algo.num_workers, num_servers=algo.num_servers,
        num_clients=algo.effective_clients, algo=algo_to_dict(algo),
        problem=problem, outdir=outdir, transport="tcp")
    tr = TcpTransport()
    rdzv_server = tr.serve(rdzv.handle, "127.0.0.1", port)
    env = _child_env(outdir)
    all_procs: list[subprocess.Popen] = []
    logs = []
    script_for: dict[str, str] = {}

    def _spawn_proc(name: str, attempt: int) -> subprocess.Popen:
        # append mode: a respawn's output lands after its predecessor's
        log = open(os.path.join(outdir, f"{name}.log"), "ab")
        logs.append(log)
        child = dict(env, REPRO_ATTEMPT=str(attempt))
        proc = subprocess.Popen(
            ["/bin/sh", script_for[name]], env=child, cwd=outdir,
            stdout=log, stderr=subprocess.STDOUT)
        all_procs.append(proc)
        return proc

    def _stash_metrics(unit) -> None:
        # keep the dying generation's partial curve for the merged
        # loss history (the respawn writes a fresh final file)
        if unit.role != "worker":
            return
        src = os.path.join(outdir, f"metrics_worker_{unit.unit}.json")
        if os.path.exists(src):
            os.replace(src, os.path.join(
                outdir,
                f"metrics_worker_{unit.unit}.pre{unit.attempt}.json"))

    sup = Supervisor(
        lambda unit: _spawn_proc(unit.name, unit.attempt),
        policy=RestartPolicy(
            max_restarts=getattr(algo, "restarts", 0) or 0,
            backoff=getattr(algo, "restart_backoff", 0.05)),
        worker_injector=injector(algo.faults, seed=algo.seed),
        server_injector=injector(getattr(algo, "server_faults", None),
                                 seed=algo.seed),
        on_respawn=_stash_metrics)
    try:
        scripts = ([p for p in paths if "server_" in os.path.basename(p)]
                   + [p for p in paths if "client_" in os.path.basename(p)])
        for path in scripts:
            name = os.path.splitext(os.path.basename(path))[0]
            script_for[name] = path
            role, _, rank = name.partition("_")
            sup.register(name, _spawn_proc(name, 0),
                         role="worker" if role == "client" else "server",
                         unit=int(rank))
        report = sup.supervise(timeout=timeout)
        if report["timed_out"]:
            for u in sup.units.values():
                if u.role == "worker" and u.proc.poll() is None:
                    u.proc.kill()
                    u.proc.wait(timeout=5.0)
        # workers are done: read server stats over a fresh connection
        # (rdzv.server_addrs holds the respawn's re-published address),
        # then tell the server processes to exit
        stats: dict[int, dict] = {}
        for rank, addr in sorted(rdzv.server_addrs.items()):
            try:
                conn = tr.connect(addr, timeout=5.0)
                st, _ = conn.request("stats")
                stats[rank] = st
                conn.request("shutdown")
                conn.close()
            except OSError:
                stats[rank] = {"error": "unreachable"}
        _fold_server_stats(result, stats)
        for name, u in sup.units.items():
            if u.role == "server":
                try:
                    u.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    u.proc.kill()
                    u.proc.wait(timeout=5.0)
            result.exit_codes[name] = u.proc.returncode
        result.respawns = report["respawns"]
        result.attempts = report["attempts"]
        result.exit_history = report["exit_history"]
        result.exhausted = report["exhausted"]
    finally:
        for proc in all_procs:
            if proc.poll() is None:
                proc.kill()
        for log in logs:
            log.close()
        rdzv_server.close()
    _aggregate(result, _collect_worker_metrics(outdir, algo.num_workers))
    if result.exhausted:
        raise JobFailed(
            "restart budget exhausted for "
            f"{', '.join(result.exhausted)} (budget="
            f"{getattr(algo, 'restarts', 0)}); exit codes: "
            + "; ".join(f"{n}={result.exit_history.get(n)}"
                        for n in result.exhausted),
            result=result)
    return result


# ---------------------------------------------------------------------------
# loopback: same code paths, threads instead of processes
# ---------------------------------------------------------------------------

def _run_loopback(algo, *, problem: str, timeout: float,
                  keep_servers: bool, device: str) -> JobResult:
    from repro_torch.net.kvserver import KVServer
    from repro_torch.net.rendezvous import (Rendezvous, algo_from_dict,
                                            algo_to_dict, join_rendezvous)
    from repro_torch.net.transport import LoopbackTransport
    from repro_torch.net.worker import WorkerKilled, run_worker

    # fail fast with the launcher's actionable message when the config
    # asks for respawns: threads cannot be SIGKILLed and re-exec'd
    _make_spec(algo, transport="loopback", port=0, device=device).validate()
    result = JobResult(transport="loopback")
    tr = LoopbackTransport()
    rdzv = Rendezvous(
        num_workers=algo.num_workers, num_servers=algo.num_servers,
        num_clients=algo.effective_clients, algo=algo_to_dict(algo),
        problem=problem, outdir="", transport="loopback")
    rdzv_server = tr.serve(rdzv.handle, "127.0.0.1", 0)
    cfg = algo_from_dict(algo_to_dict(algo))
    kvs, kv_servers = [], []
    for rank in range(algo.num_servers):
        srv = KVServer(cfg, rank=rank, device=device)
        server = tr.serve(srv.handle)
        conn = tr.connect(rdzv_server.addr)
        join_rendezvous(conn, "server", rank, addr=server.addr)
        kvs.append(srv)
        kv_servers.append(server)

    worker_out: dict[int, dict] = {}
    errors: dict[int, BaseException] = {}

    def run_one(rank: int) -> None:
        def killed() -> None:
            raise WorkerKilled(rank)

        try:
            worker_out[rank] = run_worker(
                rank=rank, rendezvous_addr=rdzv_server.addr,
                transport="loopback", on_kill=killed, device=device)
        except WorkerKilled:
            worker_out[rank] = {"killed": True, "losses": [], "gsteps": [],
                                "metrics": []}
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors[rank] = e

    threads = [threading.Thread(target=run_one, args=(rank,), daemon=True)
               for rank in range(algo.num_workers)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.5, deadline - time.monotonic()))
    stats = {}
    for rank, srv in enumerate(kvs):
        st, _ = srv.handle("stats", {}, b"")
        stats[rank] = st
    _fold_server_stats(result, stats)
    if not keep_servers:
        for server in kv_servers:
            server.close()
        rdzv_server.close()
    if errors:
        rank, err = sorted(errors.items())[0]
        raise RuntimeError(f"loopback worker {rank} failed: {err!r}") from err
    for rank in range(algo.num_workers):
        result.exit_codes[f"client_{rank}"] = (
            0 if rank in worker_out and "killed" not in worker_out[rank]
            else -9 if rank in worker_out else None)
    _aggregate(result, worker_out)
    return result


def main(argv: Optional[list] = None) -> None:
    """The CLI over ``run_job``: prints the job's summary as JSON."""
    import argparse

    from repro_torch.core.algorithms import AlgoConfig

    ap = argparse.ArgumentParser(
        description="run a transport job as local OS processes")
    ap.add_argument("--mode", default="dist_sgd",
                    choices=("dist_sgd", "dist_esgd"))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--transport", default="tcp",
                    choices=("tcp", "loopback"))
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--wire-dtype", default="f32",
                    choices=("f32", "bf16", "int8"))
    ap.add_argument("--faults", default="")
    ap.add_argument("--barrier-timeout", type=float, default=0.0)
    ap.add_argument("--restarts", type=int, default=0,
                    help="per-unit supervised-respawn budget (tcp only)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="durable KV checkpoint + state-parking cadence "
                         "in steps (0 = off)")
    ap.add_argument("--server-faults", default="",
                    help="fault schedule the SERVER tier evaluates")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every worker and server (default "
                         "cuda; cpu runs the plain kernel versions)")
    args = ap.parse_args(argv)
    algo = AlgoConfig(
        mode=args.mode, num_workers=args.workers,
        num_clients=args.workers, num_servers=args.servers,
        lr=args.lr, epochs=args.epochs, steps_per_epoch=args.steps,
        seed=0, wire_dtype=(None if args.wire_dtype == "f32"
                            else args.wire_dtype),
        faults=args.faults or None,
        barrier_timeout=args.barrier_timeout or None,
        restarts=args.restarts,
        checkpoint_every=args.checkpoint_every,
        server_faults=args.server_faults or None)
    res = run_job(algo, transport=args.transport, outdir=args.outdir,
                  timeout=args.timeout, device=args.device)
    print(json.dumps({
        "transport": res.transport, "losses": res.losses,
        "metrics": res.metrics, "final_loss": res.final_loss,
        "exit_codes": res.exit_codes,
        "degraded_syncs": res.degraded_syncs,
        "membership_epochs": res.membership_epochs, "live": res.live,
        "respawns": len(res.respawns),
        "respawn_gaps_s": [round(r["gap_s"], 4) for r in res.respawns],
        "attempts": res.attempts, "device": args.device,
    }, indent=2))


if __name__ == "__main__":
    main()
