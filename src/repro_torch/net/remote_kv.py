"""The worker's KVStore endpoint: core/kvstore.py's client API over a
Transport connection per server shard (``repro/net/remote_kv.py``).

Key routing uses ``stable_server_of`` (crc32 — `hash()` is salted per
process, so the in-process ``KVStore.server_of`` rule is mirrored with a
seed-free hash both sides agree on).

Values cross the wire as FlatBuffer-packed f32 buffers encoded per wire
dtype (net/wire.py), so each push/pull payload is exactly
``cost_model.ps_wire_nbytes(spec.size, wire_dtype)`` bytes. A push is
packed and encoded on the tree's device; a reply is decoded and unpacked
on the store's ``device`` (the card unless the caller passes
``device="cpu"``).

Fault semantics mirror ``core/faults.delivery_time``: a push attempt the
schedule drops is retried after ``backoff * 2**attempt`` REAL seconds (the
in-process simulation adds the same amount of virtual time); a push whose
every attempt drops is LOST — the worker proceeds to pull and the
server's barrier_timeout covers the hole.

Crash recovery: an optional ``reconnect`` factory (rank -> fresh
Connection, typically rendezvous ``wait_servers`` + ``connect_with_retry``
so a respawned server's NEW address is picked up) lets the client ride a
server death — ``refresh()`` rebuilds every connection, and the
state/snapshot RPCs retry through it once. The worker loop retries its
push+pull *pair* the same way (both must re-issue together for the
restored round to re-form — see net/kvserver.py's durability notes).
``put_state``/``get_state`` park exact-f32 packed state server-side; the
bytes a resume pulls are tracked in ``state_bytes_in`` and equal
``cost_model.restore_leg_bytes`` exactly.
"""
from __future__ import annotations

import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import flatbuf
from repro_torch.launch.train import resolve_device
from repro_torch.net import wire
from repro_torch.net.transport import Connection
from repro_torch.tree import tree_leaves


def stable_server_of(key: Any, num_servers: int) -> int:
    """Process-stable key -> server shard (crc32, not salted hash())."""
    return zlib.crc32(str(key).encode()) % max(num_servers, 1)


class RemoteKVStore:
    """Client endpoint over one Connection per server shard."""

    def __init__(self, conns: dict[int, Connection], *,
                 wire_dtype: Optional[str] = None, injector=None,
                 push_retries: int = 2, push_backoff: float = 0.05,
                 sleep=time.sleep,
                 reconnect: Optional[Callable[[int], Connection]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if not conns:
            raise ValueError("RemoteKVStore needs at least one connection")
        self.conns = dict(conns)
        self.num_servers = len(self.conns)
        self.wire_dtype = wire_dtype
        self.injector = injector
        self.push_retries = push_retries
        self.push_backoff = push_backoff
        self.sleep = sleep
        self.reconnect = reconnect
        self._specs: dict[Any, flatbuf.FlatBuffer] = {}
        self.pushed_bytes = 0
        self.pulled_bytes = 0
        self.push_count = 0
        self.pushes_lost = 0
        self.push_delay_s = 0.0
        self.state_bytes_out = 0
        self.state_bytes_in = 0
        self.reconnects = 0

    # -- plumbing ------------------------------------------------------------
    def _conn(self, key: Any) -> Connection:
        rank = stable_server_of(key, self.num_servers)
        return self.conns[sorted(self.conns)[rank]]

    def refresh(self) -> None:
        """Rebuild every server connection via the ``reconnect`` factory
        (rank -> Connection). The factory re-resolves addresses, so a
        respawned server's new port is found."""
        if self.reconnect is None:
            raise RuntimeError(
                "RemoteKVStore has no reconnect factory — pass reconnect= "
                "to ride a server respawn")
        for rank in sorted(self.conns):
            try:
                self.conns[rank].close()
            except Exception:
                pass
            self.conns[rank] = self.reconnect(rank)
        self.reconnects += 1

    def _request_riding(self, key: Any, op: str, meta: dict,
                        payload: bytes = b""):
        """One RPC that survives a single server death mid-flight: on a
        connection error, refresh and re-issue once (the ops routed here
        are idempotent server-side)."""
        try:
            return self._conn(key).request(op, meta, payload)
        except (OSError, wire.WireError):
            if self.reconnect is None:
                raise
            self.refresh()
            return self._conn(key).request(op, meta, payload)

    def _spec(self, key: Any, tree: Any = None) -> flatbuf.FlatBuffer:
        spec = self._specs.get(key)
        if spec is None:
            if tree is None:
                raise KeyError(f"key {key!r} has no registered spec")
            spec = self._specs[key] = flatbuf.spec_for(tree)
        return spec

    def _pack(self, key: Any, tree: Any) -> torch.Tensor:
        spec = self._spec(key, tree)
        leaves = tree_leaves(tree)
        if len(leaves) == 1 and leaves[0].dim() == 1 \
                and leaves[0].shape[0] == spec.size:
            return leaves[0].to(torch.float32)
        return spec.pack(tree)

    def _unpack(self, key: Any, buf: torch.Tensor) -> Any:
        return self._specs[key].unpack(buf)

    def _decode(self, meta: dict, payload: bytes) -> torch.Tensor:
        return wire.decode_buffer(meta, payload, self.device)

    def register(self, key: Any, tree: Any) -> flatbuf.FlatBuffer:
        """Pin the key's FlatBuffer spec (pack/unpack layout)."""
        return self._spec(key, tree)

    # -- RPCs ----------------------------------------------------------------
    def init(self, key: Any, tree: Any) -> bool:
        """Init the key server-side (exact f32; idempotent across
        workers — the first init wins, as with in-process worker 0)."""
        buf = self._pack(key, tree)
        meta, payload = wire.encode_buffer(buf, None)
        reply, _ = self._conn(key).request(
            "init", dict(meta, key=key), payload)
        return not reply.get("existing", False)

    def _should_drop(self, unit: int, step: int, attempt: int) -> bool:
        inj = self.injector
        return bool(inj is not None
                    and inj.should_drop(unit, step, attempt=attempt))

    def push(self, key: Any, tree: Any, *, step: int = 0,
             unit: int = 0) -> bool:
        """Push with the faults.delivery_time retry policy over real
        time. Returns False if every attempt dropped (push LOST)."""
        buf = self._pack(key, tree)
        meta, payload = wire.encode_buffer(buf, self.wire_dtype)
        meta = dict(meta, key=key, unit=unit, step=step)
        for attempt in range(1 + self.push_retries):
            if self._should_drop(unit, step, attempt):
                delay = self.push_backoff * (2 ** attempt)
                self.push_delay_s += delay
                self.sleep(delay)
                continue
            reply, _ = self._conn(key).request("push", meta, payload)
            self.push_count += 1
            self.pushed_bytes += len(payload)
            return not reply.get("late", False)
        self.pushes_lost += 1
        return False

    def pull(self, key: Any, *, step: int = 0,
             unit: int = 0) -> tuple[Any, dict]:
        """Blocking pull of the round's value. Returns ``(tree, info)``;
        ``tree`` is None when the round released empty (count == 0 —
        every push was lost; the worker skips the update, as the
        in-process all-lost round does)."""
        reply, payload = self._conn(key).request(
            "pull", {"key": key, "step": step, "unit": unit})
        info = {k: reply.get(k) for k in
                ("count", "degraded", "epoch", "live")}
        if not payload or info["count"] == 0:
            return None, info
        self.pulled_bytes += len(payload)
        return self._unpack(key, self._decode(reply, payload)), info

    def pushpull(self, key: Any, tree: Any, *, step: int = 0,
                 unit: int = 0) -> tuple[Any, dict]:
        buf = self._pack(key, tree)
        meta, payload = wire.encode_buffer(buf, self.wire_dtype)
        meta = dict(meta, key=key, unit=unit, step=step)
        reply, rpayload = self._conn(key).request("pushpull", meta, payload)
        self.push_count += 1
        self.pushed_bytes += len(payload)
        info = {k: reply.get(k) for k in
                ("count", "degraded", "epoch", "live")}
        if not rpayload or info["count"] == 0:
            return None, info
        self.pulled_bytes += len(rpayload)
        return self._unpack(key, self._decode(reply, rpayload)), info

    def elastic_exchange(self, key: Any, tree: Any, *, step: int = 0,
                         unit: int = 0) -> tuple[Any, dict]:
        """Atomic old-center-out / Elastic1-in (the esgd interval's
        ``old = kv.value(); kv.push()`` pair). Same loss/retry policy as
        push; a lost exchange returns (None, info) and the worker skips
        the elastic step (its next interval catches up)."""
        buf = self._pack(key, tree)
        meta, payload = wire.encode_buffer(buf, self.wire_dtype)
        meta = dict(meta, key=key, unit=unit, step=step)
        for attempt in range(1 + self.push_retries):
            if self._should_drop(unit, step, attempt):
                delay = self.push_backoff * (2 ** attempt)
                self.push_delay_s += delay
                self.sleep(delay)
                continue
            reply, rpayload = self._conn(key).request(
                "elastic_exchange", meta, payload)
            self.push_count += 1
            self.pushed_bytes += len(payload)
            self.pulled_bytes += len(rpayload)
            info = {k: reply.get(k) for k in ("epoch", "live")}
            return self._unpack(key, self._decode(reply, rpayload)), info
        self.pushes_lost += 1
        return None, {"epoch": None, "live": None}

    def value(self, key: Any) -> Any:
        """Exact f32 server value (no wire quantization) — used for
        eval-time center reads and debugging."""
        reply, payload = self._conn(key).request("value", {"key": key})
        return self._unpack(key, self._decode(reply, payload))

    def barrier(self, name: str, *, unit: int = 0) -> dict:
        """Named barrier on server 0 over the live roster."""
        reply, _ = self.conns[sorted(self.conns)[0]].request(
            "barrier", {"name": name, "unit": unit})
        return reply

    def register_group(self, gid: Any, axes, sizes) -> None:
        for rank in sorted(self.conns):
            self.conns[rank].request(
                "register_group",
                {"gid": gid, "axes": list(axes), "sizes": list(sizes)})

    def set_elastic(self, alpha: float) -> None:
        for rank in sorted(self.conns):
            self.conns[rank].request("set_elastic", {"alpha": alpha})

    # -- durable-state RPCs (crash recovery) ---------------------------------
    def _state_key(self, unit: int) -> str:
        """Routing key for a unit's parked state (stable across respawns
        and independent of the data keys)."""
        return f"state:{unit}"

    def put_state(self, unit: int, step: int,
                  sections: dict[str, torch.Tensor]) -> dict:
        """Park this unit's packed state sections (tensors on any device)
        server-side in exact f32 (resume must be bit-exact — the wire
        codec is bypassed)."""
        names = list(sections)
        arrays = [sections[n].detach().to(torch.float32).reshape(-1).cpu().numpy()
                  for n in names]
        payload = b"".join(a.tobytes() for a in arrays)
        meta = {"unit": unit, "step": step, "sections": names,
                "sizes": [int(a.size) for a in arrays]}
        reply, _ = self._request_riding(
            self._state_key(unit), "put_state", meta, payload)
        self.state_bytes_out += len(payload)
        return reply

    def get_state(self, unit: int) -> Optional[dict]:
        """The unit's parked state, or None. Returns ``{"step": int,
        "sections": {name: f32 array}}``; the payload bytes pulled equal
        ``cost_model.restore_leg_bytes(sum of section sizes)``."""
        reply, payload = self._request_riding(
            self._state_key(unit), "get_state", {"unit": unit})
        if not reply.get("found"):
            return None
        self.state_bytes_in += len(payload)
        arr = np.frombuffer(payload, np.float32)
        sections, off = {}, 0
        for name, size in zip(reply["sections"], reply["sizes"]):
            sections[name] = arr[off:off + int(size)].copy()
            off += int(size)
        return {"step": int(reply["step"]), "sections": sections}

    def snapshot(self, *, step: Optional[int] = None) -> dict[int, dict]:
        """Force a durable snapshot on every server shard."""
        meta = {} if step is None else {"step": step}
        out = {}
        for rank in sorted(self.conns):
            reply, _ = self.conns[rank].request("snapshot", dict(meta))
            out[rank] = reply
        return out

    def restore(self) -> dict[int, dict]:
        """Ask every server shard to restore its latest snapshot."""
        out = {}
        for rank in sorted(self.conns):
            reply, _ = self.conns[rank].request("restore")
            out[rank] = reply
        return out

    def server_stats(self) -> dict[int, dict]:
        out = {}
        for rank in sorted(self.conns):
            reply, _ = self.conns[rank].request("stats")
            out[rank] = reply
        return out

    def stats(self) -> dict:
        return {
            "pushed_bytes": self.pushed_bytes,
            "pulled_bytes": self.pulled_bytes,
            "push_count": self.push_count,
            "pushes_lost": self.pushes_lost,
            "push_delay_s": self.push_delay_s,
            "state_bytes_out": self.state_bytes_out,
            "state_bytes_in": self.state_bytes_in,
            "reconnects": self.reconnects,
        }

    def close(self) -> None:
        for conn in self.conns.values():
            conn.close()
