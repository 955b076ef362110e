"""The Transport abstraction: how RPC frames move between processes
(``repro/net/transport.py``; plain Python, no tensors).

Two implementations with the SAME frame/codec layer (net/wire.py):

  ``TcpTransport``       real localhost sockets — length-prefixed frames,
                         one server thread per accepted connection, so a
                         blocking handler (the sync-barrier pull) stalls
                         only its own caller
  ``LoopbackTransport``  no sockets: the handler runs on the caller's
                         thread, but every request still round-trips
                         encode_frame/decode_frame, so byte accounting
                         and serialization are bit-identical to tcp —
                         this is the in-process reference the tcp loss
                         curves are gated bit-exact against

A server handler is ``handler(op, meta, payload) -> (meta, payload)``;
exceptions become ``{"ok": false, "error": ...}`` responses which
``Connection.request`` re-raises as ``RemoteError`` on the client.
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from repro_torch.net import wire

Handler = Callable[[str, dict, bytes], "tuple[dict, bytes]"]


class RemoteError(RuntimeError):
    """The server-side handler raised; carries its message."""


class Connection:
    """One client endpoint: serialized request/response frames."""

    transport = "?"

    def request(self, op: str, meta: Optional[dict] = None,
                payload: bytes = b"") -> tuple[dict, bytes]:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - trivial
        pass


class Server:
    """One serving endpoint; ``addr`` is what clients connect() to."""

    addr = "?"

    def close(self) -> None:  # pragma: no cover - trivial
        pass


def _check_response(meta: dict) -> dict:
    if not meta.pop("ok", True):
        raise RemoteError(meta.get("error", "remote handler failed"))
    return meta


def _run_handler(handler: Handler, op: str, meta: dict,
                 payload: bytes) -> bytes:
    try:
        out_meta, out_payload = handler(op, meta, payload)
        out_meta = dict(out_meta or {})
        out_meta["ok"] = True
    except Exception as e:  # noqa: BLE001 - ships the error to the caller
        out_meta = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out_payload = b""
    return wire.encode_frame("response", out_meta, out_payload)


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------

class _TcpConnection(Connection):
    transport = "tcp"

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = self._sock.recv(n - got)
            if not chunk:
                raise wire.WireError(
                    f"connection closed mid-frame ({got}/{n} bytes)")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def request(self, op, meta=None, payload=b""):
        frame = wire.encode_frame(op, meta, payload)
        with self._lock:
            self._sock.sendall(frame)
            self.bytes_sent += len(frame)
            rop, rmeta, rpayload = wire.read_frame(self._read_exact)
        self.bytes_received += len(rpayload)
        assert rop == "response", rop
        return _check_response(rmeta), rpayload

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:  # pragma: no cover - already gone
            pass


class _TcpServer(Server):
    """Accepts on ``addr``; one daemon thread per connection. ``close``
    stops them all: the listener and every live connection are shut down
    and their threads joined, so a process that exits after ``close``
    leaves no serving thread racing its interpreter's shutdown."""

    #: how long ``close`` waits for a thread still inside a handler (a
    #: blocked barrier wait) before leaving it, a daemon, to the exit
    JOIN_S = 5.0

    def __init__(self, handler: Handler, host: str, port: int):
        self._handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._closed = threading.Event()
        self._live: dict[socket.socket, threading.Thread] = {}
        self._live_lock = threading.Lock()
        self.addr = "%s:%d" % self._sock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"tcp-serve-{self.addr}",
            daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name=f"tcp-conn-{self.addr}", daemon=True)
            with self._live_lock:
                if self._closed.is_set():
                    conn.close()
                    return
                self._live[conn] = t
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        def read_exact(n: int) -> bytes:
            chunks, got = [], 0
            while got < n:
                chunk = conn.recv(n - got)
                if not chunk:
                    raise wire.WireError("eof")
                chunks.append(chunk)
                got += len(chunk)
            return b"".join(chunks)

        try:
            while not self._closed.is_set():
                try:
                    op, meta, payload = wire.read_frame(read_exact)
                    conn.sendall(_run_handler(self._handler, op, meta, payload))
                except (wire.WireError, OSError):
                    # the peer went away (normal teardown, a kill, a
                    # reset), or close() shut the connection down
                    return
        finally:
            with self._live_lock:
                self._live.pop(conn, None)
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass

    def close(self) -> None:
        self._closed.set()
        with self._live_lock:
            live = list(self._live.items())
        # wake a thread blocked in accept() / recv() (close() alone does
        # not on Linux); a connection keeps its write side, so a response
        # still in flight (the one to "shutdown") reaches its caller
        for sock, how in [(self._sock, socket.SHUT_RDWR)] + [
                (c, socket.SHUT_RD) for c, _ in live]:
            try:
                sock.shutdown(how)
            except OSError:
                pass  # not connected, or already shut down by the peer
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
        me = threading.current_thread()
        for t in [self._accept_thread] + [t for _, t in live]:
            if t is not me:
                t.join(self.JOIN_S)


# ---------------------------------------------------------------------------
# Loopback
# ---------------------------------------------------------------------------

_LOOPBACK: dict[str, Handler] = {}
_LOOPBACK_LOCK = threading.Lock()
_LOOPBACK_SEQ = [0]


class _LoopbackConnection(Connection):
    transport = "loopback"

    def __init__(self, addr: str):
        with _LOOPBACK_LOCK:
            if addr not in _LOOPBACK:
                raise ConnectionRefusedError(
                    f"no loopback server at {addr!r} "
                    f"(live: {sorted(_LOOPBACK)})")
        self._addr = addr
        self.bytes_sent = 0
        self.bytes_received = 0

    def request(self, op, meta=None, payload=b""):
        with _LOOPBACK_LOCK:
            handler = _LOOPBACK.get(self._addr)
        if handler is None:
            raise ConnectionResetError(f"loopback server {self._addr} closed")
        # full frame round-trip on purpose: the loopback run must put the
        # same bytes "on the wire" as tcp for the byte gates to mean it
        frame = wire.encode_frame(op, meta, payload)
        self.bytes_sent += len(frame)
        sop, smeta, spayload = wire.decode_frame(frame)
        rframe = _run_handler(handler, sop, smeta, spayload)
        rop, rmeta, rpayload = wire.decode_frame(rframe)
        self.bytes_received += len(rpayload)
        assert rop == "response", rop
        return _check_response(rmeta), rpayload


class _LoopbackServer(Server):
    def __init__(self, handler: Handler):
        with _LOOPBACK_LOCK:
            _LOOPBACK_SEQ[0] += 1
            self.addr = f"loopback:{_LOOPBACK_SEQ[0]}"
            _LOOPBACK[self.addr] = handler

    def close(self) -> None:
        with _LOOPBACK_LOCK:
            _LOOPBACK.pop(self.addr, None)


# ---------------------------------------------------------------------------
# The abstraction
# ---------------------------------------------------------------------------

class Transport:
    name = "?"

    def serve(self, handler: Handler, host: str = "127.0.0.1",
              port: int = 0) -> Server:
        raise NotImplementedError

    def connect(self, addr: str) -> Connection:
        raise NotImplementedError


class TcpTransport(Transport):
    name = "tcp"

    def serve(self, handler, host="127.0.0.1", port=0):
        return _TcpServer(handler, host, port)

    def connect(self, addr, timeout: float = 30.0):
        host, _, port = addr.rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=timeout)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return _TcpConnection(sock)


class LoopbackTransport(Transport):
    name = "loopback"

    def serve(self, handler, host="127.0.0.1", port=0):
        return _LoopbackServer(handler)

    def connect(self, addr):
        return _LoopbackConnection(addr)


TRANSPORTS = {"tcp": TcpTransport, "loopback": LoopbackTransport}


def transport_for(name: str) -> Transport:
    try:
        return TRANSPORTS[name]()
    except KeyError:
        raise ValueError(
            f"transport must be one of {tuple(TRANSPORTS)}, got {name!r}"
        ) from None


def connect_with_retry(transport: Transport, addr: str,
                       timeout: float = 20.0,
                       interval: float = 0.1) -> Connection:
    """Connect, retrying while the peer process is still binding."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        try:
            return transport.connect(addr)
        except (ConnectionError, OSError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(interval)
