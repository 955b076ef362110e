"""Threads-in-one-process harness for the socket PS tier tests: a
rendezvous and KV server(s) of either package served on port 0 (or
loopback), worker threads joined with a timeout that fails the test, and
a turnstile that puts the dist_esgd exchanges in the in-process engine's
order (jitter 0: unit 0, unit 1, unit 0, ...); and ``one_thread``, the
CPU setting under which the exact holds hold."""
import contextlib
import importlib
import os
import threading

import numpy as np

JOIN_S = 60.0


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread here, and in the environment child
    processes inherit. With more threads the BLAS may use fewer of them
    when the machine is loaded (as under ``pytest -n 6``), so a small
    product rounds differently from one call to the next: the logreg8
    losses of a socket run and of the in-process run then differ in the
    5th digit, and their ``==`` fails although both runs are right."""
    import torch

    threads = torch.get_num_threads()
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    torch.set_num_threads(1)
    os.environ.update({k: "1" for k in saved})
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def net(package: str, name: str):
    """``repro.net.<name>`` or ``repro_torch.net.<name>``."""
    return importlib.import_module(f"{package}.net.{name}")


class Turnstile:
    """Exchange ``(it, unit)`` waits for its turn; the turn moves on when
    the unit reports ``progress`` for ``it`` (after its update and eval),
    so the exchanges run in the order u0 it0, u1 it0, u0 it1, ..."""

    def __init__(self, units: int):
        self.units = units
        self.turn = 0
        self.cond = threading.Condition()

    def _index(self, it: int, unit: int) -> int:
        return it * self.units + unit

    def server(self, handle):
        def wrapped(op, meta, payload):
            if op == "elastic_exchange":
                idx = self._index(int(meta["step"]), int(meta["unit"]))
                with self.cond:
                    if not self.cond.wait_for(lambda: self.turn == idx,
                                              timeout=JOIN_S):
                        raise TimeoutError(f"turn {idx} never came")
            return handle(op, meta, payload)
        return wrapped

    def rendezvous(self, handle):
        def wrapped(op, meta, payload):
            if op == "progress":
                idx = self._index(int(meta["step"]), int(meta["rank"]))
                with self.cond:
                    if self.turn == idx:
                        self.turn += 1
                        self.cond.notify_all()
            return handle(op, meta, payload)
        return wrapped


class Tier:
    """A served rendezvous + ``servers`` KV servers of ``package``; the
    job config is ``algo`` (an ``algo_to_dict``). Close it when done."""

    def __init__(self, algo: dict, *, workers: int, servers: int = 1,
                 package: str = "repro_torch", transport: str = "tcp",
                 turnstile: "Turnstile | None" = None, device: str = "cpu"):
        R, K, T = (net(package, n) for n in ("rendezvous", "kvserver",
                                             "transport"))
        tr = T.transport_for(transport)
        self.rdzv = R.Rendezvous(num_workers=workers, num_servers=servers,
                                 num_clients=workers, algo=algo,
                                 transport=transport)
        cfg = R.algo_from_dict(algo)
        kw = {"device": device} if package == "repro_torch" else {}
        self.kvs = [K.KVServer(cfg, rank=r, **kw) for r in range(servers)]
        wrap_s = turnstile.server if turnstile else (lambda h: h)
        wrap_r = turnstile.rendezvous if turnstile else (lambda h: h)
        self._served = [tr.serve(wrap_r(self.rdzv.handle))]
        self.addr = self._served[0].addr
        conn = tr.connect(self.addr)
        for r, kv in enumerate(self.kvs):
            srv = tr.serve(wrap_s(kv.handle))
            self._served.append(srv)
            R.join_rendezvous(conn, "server", r, addr=srv.addr)
        conn.close()

    def stats(self) -> dict:
        return self.kvs[0].handle("stats", {}, b"")[0]

    def close(self) -> None:
        for s in self._served:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_threads(fn, ranks) -> dict:
    """``fn(rank)`` in one thread per rank; every thread must finish
    within JOIN_S and raise nothing. -> {rank: result} in the order of
    ``ranks``, whatever order the threads finished in."""
    out, errs = {}, {}

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs[r] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    alive = [r for r, t in zip(ranks, threads) if t.is_alive()]
    assert not alive, f"worker threads {alive} still running after {JOIN_S} s"
    if errs:
        raise next(iter(errs.values()))
    return {r: out[r] for r in ranks}


def run_job(algo: dict, *, workers: int = 2, package: str = "repro_torch",
            worker_package: str = "repro_torch", transport: str = "tcp",
            ordered: bool = False, device: str = "cpu"):
    """One job: the tier of ``package``, ``workers`` worker threads of
    ``worker_package``. -> (per-rank worker outputs, server stats)."""
    W = net(worker_package, "worker")
    gate = Turnstile(workers) if ordered else None
    with Tier(algo, workers=workers, package=package, transport=transport,
              turnstile=gate, device=device) as tier:
        kw = {"device": device} if worker_package == "repro_torch" else {}
        outs = run_threads(
            lambda r: W.run_worker(rank=r, rendezvous_addr=tier.addr,
                                   transport=transport, **kw),
            list(range(workers)))
        return outs, tier.stats()


def step_means(outs: dict) -> list:
    """dist_sgd: the mean loss over workers per step (the in-process
    runner's per-step mean)."""
    ranks = sorted(outs)
    return [float(np.mean([outs[r]["losses"][i] for r in ranks]))
            for i in range(len(outs[ranks[0]]["losses"]))]


def epoch_means(outs: dict, steps_per_epoch: int) -> list:
    """dist_esgd in turnstile order: the mean over an epoch's completions
    in the in-process engine's order (u0, u1 per step)."""
    ranks = sorted(outs)
    n = len(outs[ranks[0]]["losses"])
    return [float(np.mean([outs[r]["losses"][i]
                           for i in range(e, e + steps_per_epoch)
                           for r in ranks]))
            for e in range(0, n, steps_per_epoch)]
