"""The PS server process: core/kvstore.py's server rules over a Transport
(``repro/net/kvserver.py``).

The KVStore itself is UNTOUCHED — it runs here on single-leaf values (the
FlatBuffer-packed f32 buffer every worker ships), and every server rule
(sync-barrier assign, async optimize, elastic) is linear/pointwise, so
operating in the packed domain is exactly the in-process math. The
store's values live on the server's ``device`` (the card unless the
caller passes ``device="cpu"``): a push is decoded there, the elastic
rule runs the fused ``elastic_server_flat`` kernel there, and a reply is
encoded there, only its wire form crossing to the host.

What this module adds is the *transport half* of the barrier semantics:

  rounds        sync pushes buffer per (key, step) round; when the live
                roster has all arrived they feed the KVStore in ascending
                unit order — the SAME order the in-process simulation
                pushes in, so the f32 barrier sum is bit-identical
  degraded      a blocking pull that reaches ``first_arrival +
                barrier_timeout`` (seconds on the server's ``clock``)
                releases the round with the survivor subset via
                ``kv.pull(now=...)`` — the KVStore's own degraded
                release, driven by that clock
  membership    units missing from a degraded round are evicted
                (``Membership.fail`` — epoch bump, expected_pushers
                shrinks); a push from an evicted unit re-joins it at the
                next epoch (a recovered straggler announces itself by
                pushing)
  consistency   every pull of a round returns the same summed value and
                the same ``count``, so every worker — including one whose
                own push was discarded — applies the same update and the
                replicas stay bit-identical

Crash durability adds three independent pieces:

  round values   every released round stores its summed value, so a pull
                 of an OLD round returns that round's sum (not the
                 current kv value) — the respawned worker's replay reads
                 history, and late re-pushes after a server restore are
                 discarded against the recorded round
  unit state     ``put_state``/``get_state`` park each worker's packed
                 params + optimizer state (+ step) server-side in exact
                 f32 — the respawned worker resumes from its own
                 uploaded state instead of re-initializing
  snapshots      with ``cfg.checkpoint_every`` set, every N-th sync
                 release atomically snapshots kv values, round history,
                 unit state, membership, and counters via
                 checkpoint.save_packed; a respawned server
                 ``restore_latest``s before serving. The snapshot runs
                 *before* any pull of the round is answered, so a worker
                 whose pull died mid-round safely re-issues its
                 push+pull pair: either the round is in the snapshot
                 (re-push discarded as late, pull returns the stored
                 sum) or it isn't (the round re-forms from everyone's
                 re-push) — both bit-identical, zero lost rounds.

A ``server_faults`` schedule kills the server itself: at the release of
a scheduled kill step (generation-indexed by REPRO_ATTEMPT) the process
self-SIGKILLs after the snapshot and before replying — the hardest
ordering for the workers.

Ops: init, push, pull, pushpull, elastic_exchange, value, barrier,
register_group, set_elastic, set_optimizer, put_state, get_state,
snapshot, restore, stats, shutdown.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.core.faults import injector
from repro_torch.core.kvstore import KVStore
from repro_torch.core.membership import Membership
from repro_torch.launch.train import resolve_device
from repro_torch.net import wire


class _Round:
    """One sync-barrier round of one key: who arrived, when it opened,
    and — once released — the summed value it produced."""

    __slots__ = ("arrived", "first_mono", "done", "count", "degraded",
                 "released_mono", "value")

    def __init__(self, first_mono: float):
        self.arrived: dict[int, torch.Tensor] = {}
        self.first_mono = first_mono
        self.done = False
        self.count = 0
        self.degraded = False
        self.released_mono: Optional[float] = None
        self.value: Optional[torch.Tensor] = None


class KVServer:
    """One PS server shard: transport handler around one KVStore."""

    def __init__(self, cfg, *, rank: int = 0, clock=time.monotonic,
                 ckpt_dir: Optional[str] = None, attempt: int = 0,
                 on_kill: Optional[Callable[[], None]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rank = rank
        self.clock = clock
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(getattr(cfg, "checkpoint_every", 0) or 0)
        self.attempt = attempt
        self.on_kill = on_kill
        self._inj = injector(getattr(cfg, "server_faults", None),
                             seed=getattr(cfg, "seed", 0))
        self.wire_dtype = cfg.effective_wire_dtype
        C = cfg.effective_clients
        kv_type = {
            "dist_sgd": "dist_sync", "mpi_sgd": "sync_mpi",
            "dist_asgd": "dist_async", "mpi_asgd": "async_mpi",
            "dist_esgd": "dist_async", "mpi_esgd": "async_mpi",
        }[cfg.mode]
        self.kv = KVStore.create(
            kv_type, num_workers=cfg.num_workers,
            num_servers=cfg.num_servers, num_clients=C,
            flat_exchange=cfg.flat_exchange,
            barrier_timeout=cfg.barrier_timeout)
        if cfg.mode.endswith("esgd"):
            self.kv.set_elastic(cfg.esgd_alpha)
        self.membership = Membership(C)
        self.kv.attach_membership(self.membership)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rounds: dict[tuple[Any, int], _Round] = {}
        self._barriers: dict[str, _Round] = {}
        # unit -> {"step", "names", "sections": {name: f32 array}}
        self._state: dict[int, dict] = {}
        self.bytes = {"push_in": 0, "pull_out": 0,
                      "exchange_in": 0, "exchange_out": 0,
                      "state_in": 0, "state_out": 0}
        self.degraded_latencies: list[float] = []
        self.snapshots = 0
        self.restored_from: Optional[str] = None
        self.restored_step: Optional[int] = None
        self._async_ops = 0     # snapshot cadence for the async/esgd path
        self.shutdown = threading.Event()

    # -- helpers -------------------------------------------------------------
    def _round(self, key: Any, step: int) -> _Round:
        r = self._rounds.get((key, step))
        if r is None:
            r = self._rounds[(key, step)] = _Round(self.clock())
        return r

    def _rejoin(self, unit: int) -> None:
        """A push from an evicted unit is its re-entry announcement."""
        if not self.membership.is_live(unit):
            self.membership.join(unit)

    def _release(self, key: Any, step: int, *, degraded: bool) -> None:
        """Feed the round's pushes to the KVStore in ascending unit order
        (the in-process simulation's ``for c in range(C)`` order — the
        f32 sum is bit-identical) and let its barrier/degraded logic run.
        Units missing from a degraded round are evicted."""
        r = self._rounds[(key, step)]
        for u in sorted(r.arrived):
            self.kv.push(key, r.arrived[u], at=0.0, unit=u)
        if degraded:
            # forces the store's own short release (degraded_syncs++)
            self.kv.pull(key, now=(self.kv.barrier_timeout or 0.0) + 1.0)
        r.done = True
        r.degraded = degraded
        r.count = self.kv.last_barrier_count or len(r.arrived)
        r.released_mono = self.clock()
        r.value = self.kv.value(key)   # rules store new tensors: no copy
        if degraded:
            self.degraded_latencies.append(r.released_mono - r.first_mono)
            for u in list(self.membership.live):
                if u not in r.arrived and self.membership.live_count > 1:
                    self.membership.fail(u)
        r.arrived.clear()   # the stored value is the record now
        # durability point: the snapshot lands BEFORE any pull of this
        # round is answered, so a worker whose pull dies with us can
        # always re-issue its push+pull pair against the restore
        if self.ckpt_every and self.ckpt_dir and step % self.ckpt_every == 0:
            self._snapshot_locked(step)
        if (self.on_kill is not None and self._inj is not None
                and self._inj.is_killed(self.rank, step, self.attempt)):
            self.on_kill()
        self._cond.notify_all()

    def _deadline(self, r: _Round) -> Optional[float]:
        if self.kv.barrier_timeout is None:
            return None
        return r.first_mono + self.kv.barrier_timeout

    def _decode(self, meta: dict, payload: bytes) -> torch.Tensor:
        return wire.decode_buffer(meta, payload, self.device)

    def _encode_value(self, key: Any) -> tuple[dict, bytes]:
        return wire.encode_buffer(self.kv.value(key), self.wire_dtype)

    def _pull_info(self, r: Optional[_Round], key: Any = None) -> dict:
        return {
            "count": (r.count if r is not None
                      else self.kv.push_count.get(key, 0)),
            "degraded": bool(r.degraded) if r is not None else False,
            "epoch": self.membership.epoch,
            "live": list(self.membership.live),
        }

    # -- the handler ---------------------------------------------------------
    def handle(self, op: str, meta: dict, payload: bytes):
        if op == "init":
            return self._op_init(meta, payload)
        if op == "push":
            return self._op_push(meta, payload)
        if op == "pull":
            return self._op_pull(meta)
        if op == "pushpull":
            self._op_push(meta, payload)
            return self._op_pull(meta)
        if op == "elastic_exchange":
            return self._op_exchange(meta, payload)
        if op == "value":
            with self._lock:
                vmeta, vpayload = wire.encode_buffer(
                    self.kv.value(meta["key"]), None)
            return vmeta, vpayload
        if op == "barrier":
            return self._op_barrier(meta)
        if op == "register_group":
            return self._op_register_group(meta)
        if op == "set_elastic":
            with self._lock:
                self.kv.set_elastic(float(meta["alpha"]))
            return {}, b""
        if op == "set_optimizer":
            return self._op_set_optimizer(meta)
        if op == "put_state":
            return self._op_put_state(meta, payload)
        if op == "get_state":
            return self._op_get_state(meta)
        if op == "snapshot":
            with self._cond:
                step = int(meta.get("step", self._max_released_step()))
                path = self._snapshot_locked(step)
            return {"path": path, "step": step}, b""
        if op == "restore":
            info = self.restore_latest()
            return info or {"restored": False}, b""
        if op == "stats":
            return self._op_stats()
        if op == "shutdown":
            self.shutdown.set()
            return {}, b""
        raise ValueError(f"unknown kvserver op {op!r}")

    # -- ops -----------------------------------------------------------------
    def _op_init(self, meta: dict, payload: bytes):
        key = meta["key"]
        buf = self._decode(meta, payload)
        with self._lock:
            if key in self.kv.keys():
                return {"existing": True}, b""  # idempotent re-init
            self.kv.init(key, buf)
        return {"existing": False}, b""

    def _op_push(self, meta: dict, payload: bytes):
        key, unit = meta["key"], int(meta["unit"])
        step = int(meta.get("step", 0))
        buf = self._decode(meta, payload)
        with self._cond:
            self.bytes["push_in"] += len(payload)
            self._rejoin(unit)
            if not self.kv.is_sync:
                self.kv.push(key, buf, unit=unit)
                return {"applied": True, "late": False}, b""
            r = self._round(key, step)
            if r.done:
                self.kv.late_pushes += 1
                return {"applied": False, "late": True}, b""
            r.arrived[unit] = buf
            if len(r.arrived) >= self.kv.expected_pushers:
                self._release(key, step, degraded=False)
            return {"applied": True, "late": False}, b""

    def _op_pull(self, meta: dict):
        key = meta["key"]
        step = int(meta.get("step", 0))
        with self._cond:
            if not self.kv.is_sync:
                vmeta, vpayload = self._encode_value(key)
                self.bytes["pull_out"] += len(vpayload)
                info = self._pull_info(None, key)
                return dict(vmeta, **info), vpayload
            r = self._round(key, step)
            while not r.done and not self.shutdown.is_set():
                deadline = self._deadline(r)
                if deadline is None:
                    self._cond.wait(0.1)
                    continue
                nowm = self.clock()
                if nowm >= deadline:
                    if r.arrived:
                        self._release(key, step, degraded=True)
                    else:
                        # every push of the round was lost: no update,
                        # the round just burned the timeout
                        r.done = True
                        r.degraded = True
                        r.count = 0
                        r.released_mono = nowm
                        self._cond.notify_all()
                    break
                self._cond.wait(min(0.05, deadline - nowm))
            info = self._pull_info(r)
            if r.count == 0:
                return dict(info, shape=[], wire="f32"), b""
            # the ROUND's stored sum, not the current kv value: a replayed
            # pull of an old round must read history (resume-by-replay)
            if r.value is not None:
                vmeta, vpayload = wire.encode_buffer(r.value, self.wire_dtype)
            else:
                vmeta, vpayload = self._encode_value(key)
            self.bytes["pull_out"] += len(vpayload)
            return dict(vmeta, **info), vpayload

    def _op_exchange(self, meta: dict, payload: bytes):
        """Atomic elastic exchange: return the pre-push center and apply
        Elastic1 under one lock — the in-process ``old = kv.value();
        kv.push()`` pair without a pull/push race between workers."""
        key, unit = meta["key"], int(meta.get("unit", 0))
        buf = self._decode(meta, payload)
        with self._lock:
            self.bytes["exchange_in"] += len(payload)
            old = self.kv.value(key)    # Elastic1 stores a new center
            self.kv.push(key, buf, unit=unit)
        vmeta, vpayload = wire.encode_buffer(old, self.wire_dtype)
        self.bytes["exchange_out"] += len(vpayload)
        return dict(vmeta, epoch=self.membership.epoch,
                    live=list(self.membership.live)), vpayload

    def _op_barrier(self, meta: dict):
        """A named one-shot barrier over the live roster, honoring the
        same timeout/degraded policy as the data barrier."""
        name, unit = meta["name"], int(meta["unit"])
        with self._cond:
            b = self._barriers.get(name)
            if b is None:
                b = self._barriers[name] = _Round(self.clock())
            if not b.done:
                b.arrived[unit] = torch.zeros(0)
                if len(b.arrived) >= self.kv.expected_pushers:
                    b.done = True
                    b.count = len(b.arrived)
                    self._cond.notify_all()
            while not b.done and not self.shutdown.is_set():
                deadline = self._deadline(b)
                if deadline is not None and self.clock() >= deadline:
                    b.done = True
                    b.degraded = True
                    b.count = len(b.arrived)
                    self._cond.notify_all()
                    break
                self._cond.wait(0.05 if deadline is None
                                else min(0.05, deadline - self.clock()))
            return {"count": b.count, "degraded": b.degraded}, b""

    def _op_register_group(self, meta: dict):
        from repro_torch.core.comm import Communicator

        axes = tuple(meta.get("axes", ("worker",)))
        sizes = tuple(int(s) for s in meta.get("sizes", (1,)))
        with self._lock:
            self.kv.register_group(
                meta["gid"], Communicator.world(axes, sizes))
        return {"size": int(np.prod(sizes))}, b""

    def _op_set_optimizer(self, meta: dict):
        from repro_torch.optim.sgd import adagrad, adamw, sgd

        name = meta.get("name", "sgd")
        lr = float(meta.get("lr", 0.1))
        make = {"sgd": lambda: sgd(lr, float(meta.get("momentum", 0.0))),
                "adagrad": lambda: adagrad(lr),
                "adamw": lambda: adamw(lr)}.get(name)
        if make is None:
            raise ValueError(f"optimizer must be sgd/adagrad/adamw, "
                             f"got {name!r}")
        with self._lock:
            self.kv.set_optimizer(make(),
                                  rescale=float(meta.get("rescale", 1.0)))
        return {}, b""

    # -- durable state: per-unit parking + whole-server snapshots ------------
    def _op_put_state(self, meta: dict, payload: bytes):
        """Park one unit's packed params/opt sections (exact f32 — resume
        must be bit-exact, so the wire codec is bypassed)."""
        unit, step = int(meta["unit"]), int(meta["step"])
        names = [str(n) for n in meta["sections"]]
        sizes = [int(s) for s in meta["sizes"]]
        arr = np.frombuffer(payload, np.float32)
        if arr.size != sum(sizes):
            raise ValueError(
                f"put_state payload has {arr.size} f32 values but the "
                f"section table sums to {sum(sizes)}")
        sections, off = {}, 0
        for name, size in zip(names, sizes):
            sections[name] = arr[off:off + size].copy()
            off += size
        with self._cond:
            self.bytes["state_in"] += len(payload)
            self._state[unit] = {"step": step, "names": names,
                                 "sections": sections}
        return {"stored": True, "step": step}, b""

    def _op_get_state(self, meta: dict):
        unit = int(meta["unit"])
        with self._cond:
            st = self._state.get(unit)
            if st is None:
                return {"found": False}, b""
            payload = b"".join(np.asarray(st["sections"][n], np.float32)
                               .tobytes() for n in st["names"])
            self.bytes["state_out"] += len(payload)
            return {"found": True, "step": st["step"],
                    "sections": list(st["names"]),
                    "sizes": [int(st["sections"][n].size)
                              for n in st["names"]]}, payload

    def _max_released_step(self) -> int:
        done = [s for (_, s), r in self._rounds.items() if r.done]
        return max(done) if done else 0

    def _snapshot_locked(self, step: int) -> Optional[str]:
        """Atomic durable snapshot (caller holds the lock): kv values,
        released-round sums, parked unit state, membership history, and
        counters. Returns the written path (None without a ckpt_dir)."""
        if not self.ckpt_dir:
            return None
        arrays: dict[str, np.ndarray] = {}
        keys = list(self.kv.keys())
        for i, key in enumerate(keys):
            arrays[f"kv:{i}"] = self.kv.value(key)
        rounds = []
        for (key, rstep), r in sorted(self._rounds.items(),
                                      key=lambda kv: (str(kv[0][0]),
                                                      kv[0][1])):
            if not r.done:
                continue    # partial arrivals re-form from re-pushes
            if r.value is not None:
                arrays[f"round:{len(rounds)}"] = r.value
            rounds.append([key, rstep, r.count, bool(r.degraded),
                           r.value is not None])
        state_meta = {}
        for unit, st in self._state.items():
            for i, name in enumerate(st["names"]):
                arrays[f"state:{unit}:{i}"] = st["sections"][name]
            state_meta[str(unit)] = {"step": st["step"],
                                     "names": list(st["names"])}
        meta = {
            "keys": keys,
            "rounds": rounds,
            "state": state_meta,
            "membership": [[e.kind, e.member]
                           for e in self.membership.history
                           if e.kind != "init"],
            "counters": {
                "degraded_syncs": self.kv.degraded_syncs,
                "late_pushes": self.kv.late_pushes,
                "last_barrier_count": self.kv.last_barrier_count,
                "push_count": {str(k): v
                               for k, v in self.kv.push_count.items()},
            },
        }
        path = checkpoint.checkpoint_path(self.ckpt_dir, step)
        checkpoint.save_packed(path, arrays, step=step, metadata=meta)
        self.snapshots += 1
        return path

    def restore_latest(self) -> Optional[dict]:
        """Load the newest complete snapshot (torn files skipped) and
        rebuild kv values, round history, unit state, and membership.
        No-op (returns None) without a ckpt_dir or prior snapshot."""
        if not self.ckpt_dir:
            return None
        path = checkpoint.latest_checkpoint(self.ckpt_dir)
        if path is None:
            return None
        arrays, meta = checkpoint.restore_packed(path)
        with self._cond:
            for i, key in enumerate(meta["keys"]):
                if key not in self.kv.keys():
                    self.kv.init(key, self._on_device(arrays[f"kv:{i}"]))
            n_val = 0
            for key, rstep, count, degraded, has_value in meta["rounds"]:
                r = _Round(self.clock())
                r.done = True
                r.count = int(count)
                r.degraded = bool(degraded)
                r.released_mono = self.clock()
                if has_value:
                    r.value = self._on_device(arrays[f"round:{n_val}"])
                    n_val += 1
                self._rounds[(key, int(rstep))] = r
            for unit_s, st in meta["state"].items():
                unit = int(unit_s)
                sections = {
                    name: np.asarray(arrays[f"state:{unit}:{i}"],
                                     np.float32)
                    for i, name in enumerate(st["names"])}
                self._state[unit] = {"step": int(st["step"]),
                                     "names": list(st["names"]),
                                     "sections": sections}
            for kind, member in meta["membership"]:
                if kind == "join":
                    if not self.membership.is_live(member):
                        self.membership.join(member)
                elif self.membership.is_live(member):
                    getattr(self.membership, kind)(member)
            c = meta["counters"]
            self.kv.degraded_syncs = c["degraded_syncs"]
            self.kv.late_pushes = c["late_pushes"]
            self.kv.last_barrier_count = c["last_barrier_count"]
            for k, v in c["push_count"].items():
                self.kv.push_count[k] = v
            self.restored_from = path
            self.restored_step = int(meta.get("step", 0))
            self._cond.notify_all()
        return {"restored": True, "path": path, "step": self.restored_step}

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, np.float32)).to(self.device)

    def _op_stats(self):
        with self._lock:
            return {
                "rank": self.rank,
                "degraded_syncs": self.kv.degraded_syncs,
                "late_pushes": self.kv.late_pushes,
                "last_barrier_count": self.kv.last_barrier_count,
                "push_count": dict(self.kv.push_count),
                "membership_epoch": self.membership.epoch,
                "live": list(self.membership.live),
                "membership_history": [
                    {"epoch": e.epoch, "kind": e.kind, "member": e.member,
                     "live": list(e.live)}
                    for e in self.membership.history],
                "bytes": dict(self.bytes),
                "degraded_latencies": list(self.degraded_latencies),
                "keys": [str(k) for k in self.kv.keys()],
                "snapshots": self.snapshots,
                "restored_from": self.restored_from,
                "restored_step": self.restored_step,
                "attempt": self.attempt,
                "state_units": sorted(self._state),
            }, b""


def _sigkill() -> None:  # pragma: no cover - kills the calling process
    import os
    import signal

    os.kill(os.getpid(), signal.SIGKILL)


def main() -> None:  # pragma: no cover - process entry
    import argparse
    import json
    import os

    from repro_torch.net.rendezvous import algo_from_dict, join_rendezvous
    from repro_torch.net.transport import connect_with_retry, transport_for

    ap = argparse.ArgumentParser(description="PS server process")
    ap.add_argument("--rendezvous",
                    default=os.environ.get("REPRO_RDZV_ADDR"),
                    help="host:port of the rendezvous (or REPRO_RDZV_ADDR)")
    ap.add_argument("--rank", type=int,
                    default=int(os.environ.get("REPRO_RANK", "0")))
    ap.add_argument("--transport", default="tcp")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-seconds", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="where the store's values live (default cuda; cpu "
                         "runs the plain kernel versions)")
    args = ap.parse_args()
    if not args.rendezvous:
        ap.error("--rendezvous (or REPRO_RDZV_ADDR) is required")
    attempt = int(os.environ.get("REPRO_ATTEMPT", "0"))
    transport = transport_for(args.transport)
    conn = connect_with_retry(transport, args.rendezvous)
    config, _ = conn.request("config")
    cfg = algo_from_dict(config["algo"])
    outdir = config.get("outdir")
    ckpt_dir = None
    if outdir and getattr(cfg, "checkpoint_every", 0):
        ckpt_dir = os.path.join(outdir, f"ckpt_server_{args.rank}")
    srv = KVServer(cfg, rank=args.rank, ckpt_dir=ckpt_dir, attempt=attempt,
                   on_kill=(_sigkill if getattr(cfg, "server_faults", None)
                            else None), device=args.device)
    srv.restore_latest()
    server = transport.serve(srv.handle, host=args.host, port=0)
    join_rendezvous(conn, "server", args.rank, addr=server.addr)
    deadline = time.monotonic() + args.max_seconds
    while not srv.shutdown.is_set() and time.monotonic() < deadline:
        srv.shutdown.wait(0.2)
    stats, _ = srv.handle("stats", {}, b"")
    outdir = config.get("outdir")
    if outdir:
        path = os.path.join(outdir, f"metrics_server_{args.rank}.json")
        with open(path, "w") as f:
            json.dump(stats, f, indent=2)
    server.close()
    conn.close()


if __name__ == "__main__":  # pragma: no cover
    main()
