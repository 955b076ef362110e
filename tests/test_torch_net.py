"""The port's socket PS tier, unit by unit, against the reference's
``repro.net`` on the CPU: RKV1 frames and the payload codec byte for byte
in both directions, the transports, the rendezvous' job config and
identities, key routing, the KV server's round buffering driven on a fake
clock (degraded release, eviction, re-join, a late push), the client's
drop / retry policy on an injected sleep, and the packed snapshots
(interchangeable npz files, torn and ``.tmp`` files skipped, a server's
snapshot / restore round trip). Everything is exact: equal bytes, equal
dicts, equal arrays."""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.core import algorithms as JA  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.core.kvstore import KVStore as JKVStore  # noqa: E402
from repro.net import kvserver as jkvserver, remote_kv as jremote  # noqa: E402
from repro.net import rendezvous as jrdzv, wire as jwire  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.core import algorithms as TA, cost_model  # noqa: E402
from repro_torch.core.faults import injector  # noqa: E402
from repro_torch.core.kvstore import KVStore  # noqa: E402
from repro_torch.net import rendezvous as trdzv, wire  # noqa: E402
from repro_torch.net.kvserver import KVServer  # noqa: E402
from repro_torch.net.remote_kv import RemoteKVStore, stable_server_of  # noqa: E402
from repro_torch.net.transport import (LoopbackTransport, RemoteError,  # noqa: E402
                                       TcpTransport, transport_for)

WIRES = (None, "f32", "bf16", "int8")
SIZES = (8, 128, 145, 2048)


def _buf(n, seed=0):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32) * 3
    if n >= 256:
        x[128:256] = 0.0    # one all-zero int8 bucket
    return x


# ---------------------------------------------------------------------------
# frames and the payload codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("meta", [None, {}, {"key": "grads", "unit": 3, "step": 7},
                                  {"alpha": 0.1, "shape": [2, 4], "wire": "int8",
                                   "live": [0, 1], "ok": True, "x": None}])
def test_frame_bytes_equal_reference(meta):
    for payload in (b"", b"\x01\x02\x03"):
        got = wire.encode_frame("push", meta, payload)
        assert got == jwire.encode_frame("push", meta, payload)
        for dec in (wire.decode_frame, jwire.decode_frame):
            op, m, p = dec(got)
            assert (op, m, p) == ("push", dict(meta or {}), payload)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("wd", WIRES)
def test_buffer_codec_bytes_equal_reference(wd, n):
    x = _buf(n, seed=n)
    meta, payload = wire.encode_buffer(torch.from_numpy(x), wd)
    jmeta, jpayload = jwire.encode_buffer(x, wd)
    assert meta == jmeta and payload == jpayload
    assert len(payload) == wire.payload_nbytes(n, wd) == jwire.payload_nbytes(n, wd)
    # both directions: each side decodes the other's bytes to the same f32
    got = wire.decode_buffer(jmeta, jpayload)
    want = jwire.decode_buffer(meta, payload)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if wd in (None, "f32"):
        np.testing.assert_array_equal(got.numpy(), x)
    if n >= 256 and wd == "int8":
        assert not got[128:256].any()
    frame = wire.encode_frame("push", dict(meta, key="grads", unit=1, step=2), payload)
    assert frame == jwire.encode_frame("push", dict(jmeta, key="grads", unit=1,
                                                    step=2), jpayload)


def test_buffer_codec_shapes_and_inputs():
    x = _buf(256).reshape(2, 128)
    for src in (torch.from_numpy(x), torch.from_numpy(x).double()):
        meta, payload = wire.encode_buffer(src, "int8")
        assert meta == {"shape": [2, 128], "wire": "int8"}
        assert payload == jwire.encode_buffer(x, "int8")[1]
        assert tuple(wire.decode_buffer(meta, payload).shape) == (2, 128)
    with pytest.raises(ValueError, match="wire_dtype"):
        wire.encode_buffer(torch.zeros(4), "fp8")
    with pytest.raises(ValueError, match="unknown wire form"):
        wire.decode_buffer({"shape": [4], "wire": "fp8"}, b"")
    with pytest.raises(ValueError, match="wire_dtype"):
        wire.payload_nbytes(4, "fp8")


@pytest.mark.parametrize("wd", [None, "bf16", "int8"])
def test_payload_bytes_match_cost_model(wd):
    for n in (128, 130, 2048, 21_789_696):
        assert wire.payload_nbytes(n, wd) == cost_model.ps_wire_nbytes(n, wd)


def test_frame_rejects_bad_magic_and_truncation():
    frame = wire.encode_frame("push", {"key": "w"}, b"abcd")
    with pytest.raises(wire.WireError, match="magic"):
        wire.decode_frame(b"XXXX" + frame[4:])
    with pytest.raises(wire.WireError, match="truncated"):
        wire.decode_frame(frame[:5])
    with pytest.raises(wire.WireError, match="length mismatch"):
        wire.decode_frame(frame[:-1])
    chunks = [b"XXXX" + frame[4:]]
    with pytest.raises(wire.WireError, match="magic"):
        wire.read_frame(lambda n: chunks[0][:n])


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def _echo(op, meta, payload):
    if op == "boom":
        raise KeyError("no such key")
    return dict(meta, op_seen=op), payload[::-1]


@pytest.mark.parametrize("name", ["tcp", "loopback"])
def test_transport_request_response_and_remote_error(name):
    tr = transport_for(name)
    srv = tr.serve(_echo)
    try:
        conn = tr.connect(srv.addr)
        meta, payload = conn.request("ping", {"x": 1}, b"abc")
        assert meta == {"x": 1, "op_seen": "ping"} and payload == b"cba"
        with pytest.raises(RemoteError, match="KeyError"):
            conn.request("boom")
        meta, _ = conn.request("ping")      # the connection survives it
        assert meta["op_seen"] == "ping"
        conn.close()
    finally:
        srv.close()
    if name == "tcp":
        assert srv.addr.startswith("127.0.0.1:") and not srv.addr.endswith(":0")
    else:
        with pytest.raises(ConnectionRefusedError):
            tr.connect(srv.addr)


def test_loopback_byte_accounting_matches_tcp():
    counts = {}
    for name in ("tcp", "loopback"):
        tr = transport_for(name)
        srv = tr.serve(_echo)
        conn = tr.connect(srv.addr)
        for k in range(3):
            conn.request("push", {"k": k}, bytes(100 * k))
        counts[name] = (conn.bytes_sent, conn.bytes_received)
        conn.close()
        srv.close()
    assert counts["tcp"] == counts["loopback"]
    assert counts["tcp"][1] == 300
    assert isinstance(transport_for("tcp"), TcpTransport)
    assert isinstance(transport_for("loopback"), LoopbackTransport)
    with pytest.raises(ValueError, match="transport must be"):
        transport_for("udp")


def _serving_threads(addr):
    return [t for t in threading.enumerate() if t.is_alive() and t.name.endswith(addr)]


def test_tcp_server_close_leaves_no_serving_thread(monkeypatch):
    """``close`` shuts down the listener and every live connection and
    joins their threads: an idle peer, a peer that reset its connection
    (a SO_LINGER 0 close sends RST) and one that left cleanly, none of
    them raising in its thread. A server process exits right after
    ``close``; a serving thread left running would race the interpreter's
    shutdown."""
    import socket
    import struct

    raised = []
    monkeypatch.setattr(threading, "excepthook", raised.append)
    tr = transport_for("tcp")
    srv = tr.serve(_echo)
    conns = [tr.connect(srv.addr) for _ in range(3)]
    for c in conns:
        assert c.request("ping")[0]["op_seen"] == "ping"
    assert len(_serving_threads(srv.addr)) == 4      # accept + 3 connections
    reset = conns[1]._sock
    reset.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    reset.close()
    conns[2].close()
    srv.close()                                      # conns[0] still open, idle
    assert _serving_threads(srv.addr) == []
    assert raised == []
    with pytest.raises((OSError, wire.WireError)):   # the server hung up
        conns[0].request("ping")
    conns[0].close()


#: a server process whose one connection is inside a torch op (the GIL
#: released) when its main thread closes the server and returns
_EXIT_RACE = """
import threading, time, torch
from repro_torch.net.transport import transport_for
torch.set_num_threads(1)
started = threading.Event()

def handler(op, meta, payload):
    started.set()
    a, t0 = torch.randn(600, 600), time.monotonic()
    while time.monotonic() - t0 < 1.0:
        a = a @ a / 600.0
    return {}, b""

tr = transport_for("tcp")
srv = tr.serve(handler)
threading.Thread(target=lambda: tr.connect(srv.addr).request("work"),
                 daemon=True).start()
started.wait()
time.sleep(0.05)
srv.close()
print("closed", flush=True)
"""


def test_tcp_server_process_exits_cleanly_while_a_handler_runs():
    """``close`` waits for a handler still running, so a server process that
    returns from main right after it exits 0. A serving thread left inside
    a torch op when the interpreter shuts down is killed through C++ frames
    (Python 3.12's exit of a daemon thread): "terminate called without an
    active exception", exit 134 — the KV server's exit code that
    ``run_job`` reported for a job whose losses were right."""
    import subprocess
    import sys

    import repro_torch

    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _EXIT_RACE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert (out.returncode, out.stdout) == (0, "closed\n"), out.stderr


# ---------------------------------------------------------------------------
# rendezvous: the job config and the identities are the reference's
# ---------------------------------------------------------------------------

ALGOS = [
    dict(mode="dist_sgd"),
    dict(mode="dist_esgd", num_workers=4, num_clients=4, esgd_interval=2,
         barrier_timeout=1.5, push_retries=3, optimizer="adamw"),
    dict(mode="dist_sgd", faults="kill@2:unit=1;straggle@0:unit=0:factor=3",
         barrier_timeout=0.5, checkpoint_every=2, restarts=1,
         server_faults="kill@3:unit=0"),
]


@pytest.mark.parametrize("kw", ALGOS, ids=lambda kw: kw["mode"])
@pytest.mark.parametrize("wd", [None, "int8"])
def test_algo_dict_equals_reference(kw, wd):
    t = TA.AlgoConfig(**kw, policy=TA.CollectivePolicy(method="multi_ring",
                                                       num_rings=2, wire_dtype=wd))
    j = JA.AlgoConfig(**kw, policy=JA.CollectivePolicy(method="multi_ring",
                                                       num_rings=2, wire_dtype=wd))
    d = trdzv.algo_to_dict(t)
    assert d == jrdzv.algo_to_dict(j)
    assert list(d) == list(jrdzv.algo_to_dict(j))
    back = trdzv.algo_from_dict(d)
    assert trdzv.algo_to_dict(back) == d and back.policy == t.policy
    assert jrdzv.algo_to_dict(jrdzv.algo_from_dict(d)) == d


def test_rendezvous_identities_equal_reference():
    algo = trdzv.algo_to_dict(TA.AlgoConfig(mode="dist_sgd"))
    kw = dict(num_workers=6, num_servers=2, num_clients=3, algo=algo)
    t, j = trdzv.Rendezvous(**kw), jrdzv.Rendezvous(**kw)
    for r in (3, 0, 5, 1, 4, 2):
        assert t.handle("join", {"role": "worker", "rank": r}, b"") == \
            j.handle("join", {"role": "worker", "rank": r}, b"")
    assert {(i.ps.rank, i.mpi.client, i.mpi.rank) for i in t.table} == \
        {(i.ps.rank, i.mpi.client, i.mpi.rank)
         for i in jclient.group_workers(6, 3)}
    for h in (t, j):
        h.handle("join", {"role": "server", "rank": 1, "addr": "h:2"}, b"")
        h.handle("leave", {"rank": 4}, b"")
        h.handle("progress", {"rank": 2, "step": 5}, b"")
    for op in ("live", "workers", "config"):
        assert t.handle(op, {}, b"") == j.handle(op, {}, b"")
    # a re-join is a resume at a new epoch, carrying the tier's step
    rep, _ = t.handle("join", {"role": "worker", "rank": 4}, b"")
    assert rep == j.handle("join", {"role": "worker", "rank": 4}, b"")[0]
    assert rep["resume"] == {"step": 5, "epoch": 8}
    with pytest.raises(ValueError, match="outside"):
        t.handle("join", {"role": "worker", "rank": 6}, b"")
    with pytest.raises(TimeoutError, match="servers joined"):
        t.handle("servers", {"timeout": 0.0}, b"")


def test_stable_server_of_equals_reference_and_kvstore():
    kv = KVStore("dist_sync", num_servers=3)
    for key in ("grads", "centers", "state:1", 7, ("a", 2)):
        assert stable_server_of(key, 3) == jremote.stable_server_of(key, 3)
        assert stable_server_of(key, 3) == kv.server_of(key)
        assert stable_server_of(key, 3) == JKVStore("dist_sync", num_servers=3).server_of(key)


# ---------------------------------------------------------------------------
# the KV server's round buffering on a fake clock
# ---------------------------------------------------------------------------

class _Clock:
    """Reads ``t``, then moves it on by ``step`` (0: a stopped clock)."""

    def __init__(self):
        self.t = 0.0
        self.step = 0.0

    def __call__(self):
        t = self.t
        self.t += self.step
        return t


def _push(srv, unit, step, x, wd=None):
    meta, payload = wire.encode_buffer(torch.as_tensor(x), wd)
    return srv.handle("push", dict(meta, key="g", unit=unit, step=step), payload)[0]


def test_kvserver_degraded_release_eviction_and_rejoin():
    cfg = TA.AlgoConfig(mode="dist_sgd", num_workers=2, num_clients=2,
                        num_servers=1, barrier_timeout=1.0)
    clock = _Clock()
    srv = KVServer(cfg, clock=clock, device="cpu")
    meta, payload = wire.encode_buffer(torch.zeros(256))
    assert srv.handle("init", dict(meta, key="g"), payload)[0] == {"existing": False}
    assert srv.handle("init", dict(meta, key="g"), payload)[0] == {"existing": True}
    a, b = torch.full((256,), 1.5), torch.full((256,), 2.25)
    # round 0: unit 1 never arrives; the pull past the deadline releases it
    assert _push(srv, 0, 0, a) == {"applied": True, "late": False}
    clock.t = 1.0
    rm, rp = srv.handle("pull", {"key": "g", "step": 0}, b"")
    assert rm["count"] == 1 and rm["degraded"] and rm["live"] == [0]
    assert rm["epoch"] == 1
    torch.testing.assert_close(wire.decode_buffer(rm, rp), a, rtol=0, atol=0)
    st = srv.handle("stats", {}, b"")[0]
    assert st["degraded_syncs"] == 1 and st["degraded_latencies"] == [1.0]
    assert [h["kind"] for h in st["membership_history"]] == ["init", "fail"]
    # unit 1's late push of round 0 is discarded, and re-joins it
    assert _push(srv, 1, 0, b) == {"applied": False, "late": True}
    st = srv.handle("stats", {}, b"")[0]
    assert st["late_pushes"] == 1 and st["live"] == [0, 1]
    assert st["membership_epoch"] == 2
    # round 1 is a full barrier again: the sum in ascending unit order
    _push(srv, 1, 1, b)
    _push(srv, 0, 1, a)
    rm, rp = srv.handle("pull", {"key": "g", "step": 1}, b"")
    assert rm["count"] == 2 and not rm["degraded"]
    torch.testing.assert_close(wire.decode_buffer(rm, rp), a + b, rtol=0, atol=0)
    # an old round's pull reads its stored sum, not the current value
    rm, rp = srv.handle("pull", {"key": "g", "step": 0}, b"")
    torch.testing.assert_close(wire.decode_buffer(rm, rp), a, rtol=0, atol=0)
    # a round whose every push was lost releases empty at its deadline
    clock.t, clock.step = 5.0, 0.25
    rm, rp = srv.handle("pull", {"key": "g", "step": 2}, b"")
    assert rm["count"] == 0 and rm["degraded"] and rp == b""
    st = srv.handle("stats", {}, b"")[0]
    assert st["bytes"]["push_in"] == 4 * 256 * 4
    with pytest.raises(ValueError, match="unknown kvserver op"):
        srv.handle("nope", {}, b"")


def test_kvserver_barrier_degrades_on_clock_and_completes():
    """A named barrier: alone past the timeout (a clock that moves 0.2 s
    per read) it releases degraded; with both units it releases whole."""
    clock = _Clock()
    clock.step = 0.2
    cfg = TA.AlgoConfig(mode="dist_sgd", num_workers=2, num_clients=2,
                        barrier_timeout=0.5)
    srv = KVServer(cfg, clock=clock, device="cpu")
    assert srv.handle("barrier", {"name": "b0", "unit": 0}, b"")[0] == \
        {"count": 1, "degraded": True}
    srv = KVServer(dataclasses.replace(cfg, barrier_timeout=None), device="cpu")
    out = {}
    t = threading.Thread(target=lambda: out.update(
        srv.handle("barrier", {"name": "b1", "unit": 0}, b"")[0]), daemon=True)
    t.start()
    for _ in range(1000):      # unit 0 has arrived before unit 1 does
        with srv._lock:
            if "b1" in srv._barriers and srv._barriers["b1"].arrived:
                break
        time.sleep(0.01)
    assert srv.handle("barrier", {"name": "b1", "unit": 1}, b"")[0] == \
        {"count": 2, "degraded": False}
    t.join(10)
    assert not t.is_alive() and out == {"count": 2, "degraded": False}


def test_kvserver_elastic_exchange_and_rules():
    cfg = TA.AlgoConfig(mode="dist_esgd", num_workers=2, num_clients=2,
                        esgd_alpha=0.25)
    srv = KVServer(cfg, device="cpu")
    c0 = torch.from_numpy(_buf(1024, 1))
    w = torch.from_numpy(_buf(1024, 2))
    meta, payload = wire.encode_buffer(c0)
    srv.handle("init", dict(meta, key="c"), payload)
    meta, payload = wire.encode_buffer(w)
    rm, rp = srv.handle("elastic_exchange", dict(meta, key="c", unit=1), payload)
    # the pre-push center comes back; Elastic1 ran on the stored one
    torch.testing.assert_close(wire.decode_buffer(rm, rp), c0, rtol=0, atol=0)
    vm, vp = srv.handle("value", {"key": "c"}, b"")
    want = jkvserver.KVServer(JA.AlgoConfig(mode="dist_esgd", num_workers=2,
                                            num_clients=2, esgd_alpha=0.25))
    jm, jp = jwire.encode_buffer(c0.numpy())
    want.handle("init", dict(jm, key="c"), jp)
    jm, jp = jwire.encode_buffer(w.numpy())
    want.handle("elastic_exchange", dict(jm, key="c", unit=1), jp)
    assert vp == want.handle("value", {"key": "c"}, b"")[1]
    st = srv.handle("stats", {}, b"")[0]
    assert st["bytes"]["exchange_in"] == st["bytes"]["exchange_out"] == 4096
    assert srv.handle("register_group", {"gid": 0, "axes": ["worker"],
                                         "sizes": [2]}, b"")[0] == {"size": 2}
    srv.handle("set_optimizer", {"name": "adamw", "lr": 0.01}, b"")
    with pytest.raises(ValueError, match="optimizer must be"):
        srv.handle("set_optimizer", {"name": "lamb"}, b"")


# ---------------------------------------------------------------------------
# the client: drop / retry on an injected sleep, lost pushes
# ---------------------------------------------------------------------------

def test_remote_kv_drop_retry_and_lost_push():
    cfg = TA.AlgoConfig(mode="dist_esgd", num_workers=2, num_clients=2)
    srv = KVServer(cfg, device="cpu")
    tr = transport_for("loopback")
    served = tr.serve(srv.handle)
    slept = []
    rkv = RemoteKVStore({0: tr.connect(served.addr)}, wire_dtype="int8",
                        injector=injector("drop@1:unit=0:duration=2;"
                                          "drop@2:unit=0:duration=3"),
                        push_retries=2, push_backoff=0.05, sleep=slept.append,
                        device="cpu")
    tree = {"w": torch.ones(3, 5), "b": torch.zeros(5)}
    assert rkv.init("centers", tree) is True
    assert rkv.init("centers", tree) is False
    new, info = rkv.elastic_exchange("centers", tree, step=0, unit=0)
    assert slept == [] and info["live"] == [0, 1]
    assert {k: tuple(v.shape) for k, v in new.items()} == {"w": (3, 5), "b": (5,)}
    # step 1: two attempts drop, the third gets through
    new, _ = rkv.elastic_exchange("centers", tree, step=1, unit=0)
    assert new is not None and slept == [0.05, 0.1]
    # step 2: every attempt drops: the exchange is lost
    new, info = rkv.elastic_exchange("centers", tree, step=2, unit=0)
    assert new is None and info == {"epoch": None, "live": None}
    assert slept == [0.05, 0.1, 0.05, 0.1, 0.2]
    st = rkv.stats()
    n = 1024
    assert st["push_count"] == 2 and st["pushes_lost"] == 1
    assert st["pushed_bytes"] == 2 * cost_model.ps_wire_nbytes(n, "int8")
    assert st["push_delay_s"] == pytest.approx(0.5)
    # a plain push under the same policy, and the exact-f32 value read
    assert rkv.push("centers", tree, step=2, unit=0) is False
    got = rkv.value("centers")
    assert got["w"].dtype == torch.float32
    rkv.close()
    served.close()
    with pytest.raises(ValueError, match="at least one"):
        RemoteKVStore({}, device="cpu")


# ---------------------------------------------------------------------------
# packed snapshots
# ---------------------------------------------------------------------------

def test_packed_checkpoints_interchangeable(tmp_path):
    arrays = {"kv:0": np.arange(6, dtype=np.float32),
              "state:1:0": np.linspace(0, 1, 5, dtype=np.float32)}
    meta = {"keys": ["grads"], "rounds": [["grads", 0, 2, False, True]]}
    for save, load in ((tckpt.save_packed, jckpt.restore_packed),
                       (jckpt.save_packed, tckpt.restore_packed)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, arrays, step=3, metadata=meta)
        got, gmeta = load(path)
        assert gmeta == dict(meta, step=3, packed=True)
        assert sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v)
    # torch tensors are written as their f32 values
    path = tckpt.checkpoint_path(str(tmp_path), 9)
    tckpt.save_packed(path, {"kv:0": torch.arange(4.0)}, step=9)
    np.testing.assert_array_equal(jckpt.restore_packed(path)[0]["kv:0"],
                                  np.arange(4, dtype=np.float32))


def test_latest_checkpoint_skips_torn_and_tmp_files(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_checkpoint(d) is None
    assert tckpt.latest_checkpoint(str(tmp_path / "nope")) is None
    good = tckpt.checkpoint_path(d, 1)
    tckpt.save_packed(good, {"kv:0": np.arange(4, dtype=np.float32)}, step=1)
    with open(tckpt.checkpoint_path(d, 2), "wb") as f:
        f.write(b"PK\x03\x04 this is not a zip archive")
    with open(os.path.join(d, "ckpt_3.npz.tmp"), "wb") as f:
        f.write(b"partial")
    assert tckpt.latest_checkpoint(d) == good == jckpt.latest_checkpoint(d)
    assert tckpt.restore_packed(good)[1]["step"] == 1


def test_kvserver_snapshot_restore_roundtrip(tmp_path):
    """A respawned server restores the released-round sums and the parked
    unit state from its latest snapshot; the reference's server restores
    the same snapshot to the same bytes."""
    cfg = TA.AlgoConfig(mode="dist_sgd", num_workers=2, num_clients=2,
                        num_servers=1, lr=0.05, epochs=1, steps_per_epoch=2,
                        compute_time=0.0, jitter=0.0, checkpoint_every=1)
    srv = KVServer(cfg, ckpt_dir=str(tmp_path), device="cpu")
    meta, payload = wire.encode_buffer(torch.zeros(256))
    srv.handle("init", dict(meta, key="w"), payload)
    for unit in (0, 1):
        _push_w = wire.encode_buffer(torch.full((256,), float(unit + 1)))
        srv.handle("push", dict(_push_w[0], key="w", unit=unit, step=0), _push_w[1])
    assert srv.snapshots == 1
    pm, pp = srv.handle("pull", {"key": "w", "step": 0}, b"")
    parked = np.arange(8, dtype=np.float32)
    srv.handle("put_state", {"unit": 1, "step": 1, "sections": ["params"],
                             "sizes": [8]}, parked.tobytes())
    srv.handle("snapshot", {"step": 0}, b"")
    jcfg = JA.AlgoConfig(mode="dist_sgd", num_workers=2, num_clients=2,
                         num_servers=1, lr=0.05, epochs=1, steps_per_epoch=2,
                         compute_time=0.0, jitter=0.0, checkpoint_every=1)
    for fresh in (KVServer(cfg, ckpt_dir=str(tmp_path), attempt=1, device="cpu"),
                  jkvserver.KVServer(jcfg, ckpt_dir=str(tmp_path), attempt=1)):
        info, _ = fresh.handle("restore", {}, b"")
        assert info["restored"] and info["step"] == 0
        rm, rp = fresh.handle("pull", {"key": "w", "step": 0}, b"")
        assert rp == pp and rm["count"] == pm["count"] == 2 and not rm["degraded"]
        sm, sp = fresh.handle("get_state", {"unit": 1}, b"")
        assert sm["found"] and sm["step"] == 1 and sm["sections"] == ["params"]
        assert sp == parked.tobytes()
        # a replayed push of the restored round is late
        again = wire.encode_buffer(torch.ones(256))
        assert fresh.handle("push", dict(again[0], key="w", unit=0, step=0),
                            again[1])[0]["late"]
    with pytest.raises(ValueError, match="section table"):
        srv.handle("put_state", {"unit": 0, "step": 0, "sections": ["p"],
                                 "sizes": [3]}, parked.tobytes())
    assert KVServer(cfg, device="cpu").restore_latest() is None
