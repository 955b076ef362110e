"""The rendezvous / scheduler endpoint (paper §4.1.2's front-end role;
``repro/net/rendezvous.py``). Its job config and identities are the
reference's, so a worker of either package can join either rendezvous.

The launcher computes the grouping; this process hands it out. Lifecycle:

  1. the runner (or ``python -m repro_torch.net.rendezvous``) serves this
     handler at the address every emitted script carries in
     ``REPRO_RDZV_ADDR``
  2. each KV server binds its own serving socket, then ``join``s with
     ``role=server`` publishing that address
  3. each worker ``join``s with ``role=worker`` and receives its PS and
     MPI identity (core/client.py's ``group_workers`` — the rendezvous
     table is keyed by ``WorkerIdentity``) plus the job config
  4. workers block on ``servers`` until the full server tier is up, then
     connect their ``RemoteKVStore``s
  5. worker 0 inits the keys and raises a flag; the rest ``wait_flag``
  6. joins/leaves advance the epoch'd live set (``live`` op); barrier-
     level failure detection lives in the KV server (net/kvserver.py)

Crash recovery: workers report their step via ``progress``; a
re-join of a rank already in the table (the supervisor's respawn, or a
push-announced straggler return) is re-admitted at a NEW epoch with a
``resume`` record carrying the tier's current step — the respawned
worker then pulls its parked state from the PS (kvserver
``get_state``) and replays forward instead of re-initializing. A
server re-join simply replaces its published address, so workers
riding ``connect_with_retry`` find the respawned server.

Ops: config, join, servers, live, leave, set_flag, wait_flag, workers,
progress, shutdown.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

from repro_torch.core.client import WorkerIdentity, group_workers
from repro_torch.net.transport import Connection, transport_for

#: AlgoConfig constructor args the job config ships (everything the
#: worker loop needs; ``net`` stays the default cost-model preset and
#: the collective policy rides as its own ``policy`` sub-dict)
_ALGO_FIELDS = (
    "mode", "num_workers", "num_clients", "num_servers", "lr", "momentum",
    "esgd_alpha", "esgd_interval", "epochs", "steps_per_epoch",
    "compute_time", "jitter", "model_bytes", "seed",
    "optimizer", "fused_update", "flat_exchange", "barrier_timeout",
    "push_retries", "push_backoff",
    "checkpoint_every", "restarts", "restart_backoff", "server_faults",
)


def algo_to_dict(cfg) -> dict:
    """JSON-safe AlgoConfig: the wire form the rendezvous hands out."""
    from repro_torch.core.faults import as_schedule

    out = {k: getattr(cfg, k) for k in _ALGO_FIELDS}
    out["policy"] = cfg.policy.to_dict()
    sched = as_schedule(cfg.faults, seed=cfg.seed)
    out["faults"] = sched.format() if sched is not None else ""
    return out


def algo_from_dict(d: dict):
    from repro_torch.core.algorithms import AlgoConfig
    from repro_torch.core.comm import CollectivePolicy

    kw = {k: v for k, v in d.items() if k in _ALGO_FIELDS or k == "faults"}
    if not kw.get("faults"):
        kw["faults"] = None
    if not kw.get("server_faults"):
        kw["server_faults"] = None
    pol = d.get("policy")
    if pol is not None:
        kw["policy"] = CollectivePolicy.from_dict(pol)
    return AlgoConfig(**kw)


class Rendezvous:
    """Server-side rendezvous state + frame handler."""

    def __init__(self, *, num_workers: int, num_servers: int,
                 num_clients: int, algo: dict, problem: str = "logreg8",
                 outdir: str = "", transport: str = "tcp"):
        self.num_workers = num_workers
        self.num_servers = num_servers
        self.num_clients = num_clients
        self.config = {
            "algo": algo, "problem": problem, "outdir": outdir,
            "transport": transport, "num_workers": num_workers,
            "num_servers": num_servers, "num_clients": num_clients,
        }
        self.identities = group_workers(num_workers, num_clients)
        # the rendezvous table: WorkerIdentity -> join record (frozen
        # dataclasses hash stably, so identities ARE the keys)
        self.table: dict[WorkerIdentity, dict] = {}
        self.server_addrs: dict[int, str] = {}
        self._live: set[int] = set()
        self._events: list[dict] = []
        self._flags: set[str] = set()
        self._progress: dict[int, int] = {}    # rank -> last reported step
        self.shutdown = threading.Event()
        self._cond = threading.Condition()

    # -- state ---------------------------------------------------------------
    @property
    def epoch(self) -> int:
        return len(self._events)

    def _bump(self, kind: str, rank: int) -> None:
        self._events.append(
            {"epoch": self.epoch + 1, "kind": kind, "rank": rank,
             "live": sorted(self._live)})

    # -- handler -------------------------------------------------------------
    def handle(self, op: str, meta: dict, payload: bytes):
        if op == "config":
            return dict(self.config), b""
        if op == "join":
            return self._join(meta), b""
        if op == "servers":
            timeout = float(meta.get("timeout", 60.0))
            with self._cond:
                ok = self._cond.wait_for(
                    lambda: len(self.server_addrs) >= self.num_servers,
                    timeout=timeout)
            if not ok:
                raise TimeoutError(
                    f"only {len(self.server_addrs)}/{self.num_servers} "
                    f"servers joined within {timeout:g}s")
            return {"addrs": {str(r): a
                              for r, a in sorted(self.server_addrs.items())}
                    }, b""
        if op == "live":
            with self._cond:
                return {"epoch": self.epoch, "live": sorted(self._live),
                        "events": list(self._events)}, b""
        if op == "leave":
            with self._cond:
                self._live.discard(int(meta["rank"]))
                self._bump("leave", int(meta["rank"]))
            return {"epoch": self.epoch}, b""
        if op == "set_flag":
            with self._cond:
                self._flags.add(meta["name"])
                self._cond.notify_all()
            return {}, b""
        if op == "wait_flag":
            timeout = float(meta.get("timeout", 60.0))
            name = meta["name"]
            with self._cond:
                ok = self._cond.wait_for(lambda: name in self._flags,
                                         timeout=timeout)
            if not ok:
                raise TimeoutError(f"flag {name!r} not raised in {timeout:g}s")
            return {}, b""
        if op == "workers":
            with self._cond:
                return {"workers": [
                    dict(rec, rank=ident.ps.rank)
                    for ident, rec in sorted(
                        self.table.items(), key=lambda kv: kv[0].ps.rank)
                ]}, b""
        if op == "progress":
            rank, step = int(meta["rank"]), int(meta["step"])
            with self._cond:
                self._progress[rank] = max(self._progress.get(rank, -1),
                                           step)
                return {"step": self._current_step()}, b""
        if op == "shutdown":
            self.shutdown.set()
            with self._cond:
                self._cond.notify_all()
            return {}, b""
        raise ValueError(f"unknown rendezvous op {op!r}")

    def _current_step(self) -> int:
        """The tier's current step: the max any worker has reported
        (-1 before the first report)."""
        return max(self._progress.values(), default=-1)

    def _join(self, meta: dict) -> dict:
        role = meta["role"]
        rank = int(meta["rank"])
        if role == "server":
            if not 0 <= rank < self.num_servers:
                raise ValueError(
                    f"server rank {rank} outside [0, {self.num_servers})")
            with self._cond:
                self.server_addrs[rank] = meta["addr"]
                self._cond.notify_all()
            return {"config": self.config}
        if role != "worker":
            raise ValueError(f"role must be server/worker, got {role!r}")
        if not 0 <= rank < self.num_workers:
            raise ValueError(
                f"worker rank {rank} outside [0, {self.num_workers})")
        ident = self.identities[rank]
        with self._cond:
            rejoin = ident in self.table
            self.table[ident] = {
                "ps": dataclasses.asdict(ident.ps),
                "mpi": dataclasses.asdict(ident.mpi),
            }
            self._live.add(rank)
            self._bump("resume" if rejoin else "join", rank)
            rec = self.table[ident]
            out = {"config": self.config, "ps": rec["ps"],
                   "mpi": rec["mpi"], "epoch": self.epoch}
            if rejoin:
                # re-admission at a new epoch: tell the respawn where
                # the tier is so it can validate its parked-state resume
                out["resume"] = {"step": self._current_step(),
                                 "epoch": self.epoch}
        return out


def join_rendezvous(conn: Connection, role: str, rank: int,
                    addr: Optional[str] = None) -> dict:
    """Client-side join; returns the assignment dict."""
    meta: dict[str, Any] = {"role": role, "rank": rank}
    if addr is not None:
        meta["addr"] = addr
    reply, _ = conn.request("join", meta)
    return reply


def wait_servers(conn: Connection, timeout: float = 60.0) -> dict[int, str]:
    reply, _ = conn.request("servers", {"timeout": timeout})
    return {int(r): a for r, a in reply["addrs"].items()}


def main() -> None:  # pragma: no cover - process entry
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description="rendezvous/scheduler process")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9091)
    ap.add_argument("--config", required=True,
                    help="path to a JSON job config (the 'config' op's "
                         "payload: algo/problem/outdir/num_*)")
    ap.add_argument("--transport", default="tcp")
    ap.add_argument("--max-seconds", type=float, default=600.0,
                    help="orphan guard: exit even without a shutdown op")
    args = ap.parse_args()
    with open(args.config) as f:
        cfg = json.load(f)
    rdzv = Rendezvous(
        num_workers=cfg["num_workers"], num_servers=cfg["num_servers"],
        num_clients=cfg["num_clients"], algo=cfg["algo"],
        problem=cfg.get("problem", "logreg8"),
        outdir=cfg.get("outdir", ""),
        transport=cfg.get("transport", args.transport))
    server = transport_for(args.transport).serve(
        rdzv.handle, args.host, args.port)
    print(f"rendezvous at {server.addr}", flush=True)
    deadline = time.monotonic() + args.max_seconds
    while not rdzv.shutdown.is_set() and time.monotonic() < deadline:
        rdzv.shutdown.wait(0.2)
    server.close()


if __name__ == "__main__":  # pragma: no cover
    main()
