"""The per-process worker loop for dist_sgd / dist_esgd over a Transport
(``repro/net/worker.py``).

Parity with core/algorithms.py is the contract, so the loop reuses the
in-process building blocks verbatim — ``_member_grads`` / ``_client_grad``
for gradients, ``_make_opt`` for the update rule (the fused flat
optimizer kernel), ``_div`` for the rescale, the packed elastic client
update (the fused ``elastic_client_flat`` kernel) for esgd — and only
replaces the simulated KVStore calls with RemoteKVStore RPCs. Params,
grads and optimizer state live on the worker's ``device`` (the card
unless the caller passes ``device="cpu"``):

  dist_sgd   compute grads -> push(grads) -> blocking pull of the round's
             SUM -> divide by ``count * workers_per_client`` (the same
             rescale the in-process faulted runner uses; on full rounds
             count == num_workers, so the clean run divides by exactly
             the in-process ``num_workers``) -> opt.update
  dist_esgd  local SGD; every ``esgd_interval`` iterations an atomic
             elastic_exchange (old center out, Elastic1 in) and the
             Elastic2 client update

Faults run REAL here: ``kill`` SIGKILLs the process mid-run (the
server's barrier_timeout is the failure detector), ``straggle``/``delay``
sleep wall-clock seconds, ``drop`` rides RemoteKVStore's retry/backoff.

Crash recovery:

  resume        a respawned process (REPRO_ATTEMPT > 0) re-joins the
                rendezvous (re-admitted with a ``resume`` record), pulls
                its parked packed params + optimizer state from the PS
                (``get_state``) instead of re-initializing, and REPLAYS
                forward from the parked step: replayed pushes to already-
                released rounds are discarded as late, replayed pulls
                return each round's STORED sum (net/kvserver.py), so the
                catch-up updates are bit-identical — and at the live
                round its fresh push completes the barrier whole
  generation    kills are generation-indexed (core/faults.py): spawn a
                dies at the (a+1)-th scheduled kill, so a respawn is not
                instantly re-killed by the event that killed its parent
  state upload  every ``cfg.checkpoint_every`` completed steps the
                worker parks exact-f32 packed params+opt server-side
                (``put_state``) — the resume source
  flush         partial metrics are flushed atomically after EVERY step,
                so the pre-kill curve survives a kill (the killed
                worker's losses come from ITS data shard — the
                aggregated mean needs them)
  server death  the push+pull pair (and the esgd exchange) retries
                through ``RemoteKVStore.refresh`` with addresses
                re-resolved from the rendezvous, riding a KV server
                respawn mid-round
"""
from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import flatbuf
from repro_torch.core.algorithms import (_client_grad, _div, _make_opt,
                                         _member_grads, _worker_group)
from repro_torch.core.elastic import (elastic_client_packed,
                                      elastic_client_update)
from repro_torch.launch.train import resolve_device
from repro_torch.tree import tree_leaves, tree_map


class WorkerKilled(Exception):
    """Raised instead of SIGKILL when the worker runs in a thread."""


def _sigkill() -> None:  # pragma: no cover - by design unreachable after
    os.kill(os.getpid(), signal.SIGKILL)


def run_worker(*, rank: int, rendezvous_addr: str, transport: str = "tcp",
               on_kill: Optional[Callable[[], None]] = None,
               rdzv_conn=None, attempt: int = 0, device="cuda") -> dict:
    """Join the rendezvous, run the assigned mode, return the metrics
    dict (also written to ``outdir/metrics_worker_<rank>.json`` by
    ``main``). ``on_kill`` fires when the fault schedule kills this
    worker (default: real SIGKILL; loopback threads raise instead).
    ``attempt`` is the spawn generation (REPRO_ATTEMPT): respawns resume
    from their parked server-side state."""
    import json

    from repro_torch.core.faults import injector
    from repro_torch.net.problem import build_problem
    from repro_torch.net.remote_kv import RemoteKVStore
    from repro_torch.net.rendezvous import (algo_from_dict, join_rendezvous,
                                            wait_servers)
    from repro_torch.net.transport import connect_with_retry, transport_for

    device = resolve_device(device)
    tr = transport_for(transport)
    conn = rdzv_conn or connect_with_retry(tr, rendezvous_addr)
    reply = join_rendezvous(conn, "worker", rank)
    config = reply["config"]
    cfg = algo_from_dict(config["algo"])
    if cfg.workers_per_client != 1:
        raise ValueError(
            "transport workers are one process per worker: "
            "num_clients must equal num_workers "
            f"(got {cfg.num_clients} clients / {cfg.num_workers} workers)")
    prob = build_problem(config.get("problem", "logreg8"), device=device)
    addrs = wait_servers(conn)
    conns = {r: connect_with_retry(tr, a) for r, a in addrs.items()}
    inj = injector(cfg.faults, seed=cfg.seed)

    def reconnect(server_rank: int):
        """Fresh connection to a (possibly respawned) server: re-resolve
        the address from the rendezvous each try — the respawn publishes
        a NEW port when it re-joins."""
        deadline = time.monotonic() + 60.0
        while True:
            fresh = wait_servers(conn)
            try:
                return tr.connect(fresh[server_rank], timeout=2.0)
            except (ConnectionError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)

    rkv = RemoteKVStore(conns, wire_dtype=cfg.effective_wire_dtype,
                        injector=inj, push_retries=cfg.push_retries,
                        push_backoff=cfg.push_backoff, reconnect=reconnect,
                        device=device)
    kill = on_kill or _sigkill

    flush = None
    outdir = config.get("outdir")
    if outdir:
        path = os.path.join(outdir, f"metrics_worker_{rank}.json")

        def flush(partial: dict) -> None:
            tmp = path + ".part"
            with open(tmp, "w") as f:
                json.dump(_jsonable(dict(partial, rank=rank,
                                         attempt=attempt)), f)
            os.replace(tmp, path)

    try:
        if cfg.mode == "dist_sgd":
            out = _run_dist_sgd(cfg, prob, rkv, conn, rank, inj, kill,
                                attempt=attempt, flush=flush)
        elif cfg.mode == "dist_esgd":
            out = _run_dist_esgd(cfg, prob, rkv, conn, rank, inj, kill,
                                 attempt=attempt, flush=flush)
        else:
            raise ValueError(
                f"transport mode must be dist_sgd/dist_esgd, got "
                f"{cfg.mode!r} (async/mpi modes stay in-process for now)")
        out["rank"] = rank
        out["attempt"] = attempt
        out["resume"] = reply.get("resume")
        out["ps"] = reply.get("ps")
        out["mpi"] = reply.get("mpi")
        out["kv"] = rkv.stats()
        return out
    finally:
        try:
            conn.request("leave", {"rank": rank})
        except Exception:  # noqa: BLE001 - rendezvous may already be gone
            pass
        rkv.close()


def _init_key(cfg, prob, rkv, conn, rank: int, key: str, tree: Any) -> None:
    """Worker 0 inits the key server-side and raises the rendezvous
    flag; everyone else pins the local spec and waits for the flag."""
    rkv.register(key, tree)
    if rank == 0:
        rkv.init(key, tree)
        rkv.register_group(0, ("worker",), (cfg.workers_per_client,))
        conn.request("set_flag", {"name": f"init:{key}"})
    else:
        conn.request("wait_flag", {"name": f"init:{key}", "timeout": 120.0})


def _straggle_sleep(inj, unit: int, gstep: int, compute_time: float) -> None:
    if inj is None:
        return
    extra = ((inj.straggle_factor(unit, gstep) - 1.0) * compute_time
             + inj.delay(unit, gstep))
    if extra > 0:
        time.sleep(extra)


def _riding(rkv, fn, tries: int = 3):
    """Run ``fn()`` riding a KV-server respawn: on a connection failure
    refresh every server connection (addresses re-resolved) and retry.
    For the sync push+pull PAIR the whole pair must re-issue together —
    the re-push is either discarded as late (round in the snapshot) or
    re-forms the restored round; both read the same stored sum."""
    from repro_torch.net import wire as _wire

    last: Optional[BaseException] = None
    for _ in range(tries):
        try:
            return fn()
        except (ConnectionError, OSError, _wire.WireError) as e:
            last = e
            if rkv.reconnect is None:
                raise
            rkv.refresh()
    assert last is not None
    raise last


def _progress(conn, rank: int, gstep: int) -> None:
    try:
        conn.request("progress", {"rank": rank, "step": gstep})
    except Exception:  # noqa: BLE001 - progress is advisory
        pass


def _park_state(cfg, rkv, rank: int, gstep: int, pspec, ospec,
                params, opt_state) -> None:
    """Upload exact-f32 packed params (+ opt state) after completing
    ``gstep`` — the respawn's resume point."""
    sections = {"params": pspec.pack(params)}
    if ospec is not None:
        sections["opt"] = ospec.pack(opt_state)
    _riding(rkv, lambda: rkv.put_state(rank, gstep, sections))


def _unpark_state(rkv, rank: int, pspec, ospec):
    """The parked (params, opt_state, step) for a respawn, or None."""
    st = _riding(rkv, lambda: rkv.get_state(rank))
    if st is None:
        return None

    def on_device(name):
        return torch.from_numpy(st["sections"][name]).to(rkv.device)

    params = pspec.unpack(on_device("params"))
    opt_state = None
    if ospec is not None and "opt" in st["sections"]:
        opt_state = ospec.unpack(on_device("opt"))
    return params, opt_state, st["step"]


def _init_params(cfg, prob):
    return prob.init_fn(torch.Generator().manual_seed(cfg.seed))


def _opt_spec(opt_state):
    return flatbuf.spec_for(opt_state) if tree_leaves(opt_state) else None


def _run_dist_sgd(cfg, prob, rkv, conn, rank, inj, kill, *,
                  attempt: int = 0, flush=None) -> dict:
    params = _init_params(cfg, prob)
    _init_key(cfg, prob, rkv, conn, rank, "grads",
              tree_map(torch.zeros_like, params))
    pipeline = prob.make_pipeline(rank)
    opt = _make_opt(cfg, params)
    opt_state = opt.init(params)
    wpc = cfg.workers_per_client
    pspec = flatbuf.spec_for(params)
    ospec = _opt_spec(opt_state)

    start = 0
    resumed_from = None
    if attempt > 0:
        parked = _unpark_state(rkv, rank, pspec, ospec)
        if parked is not None:
            params, parked_opt, parked_step = parked
            if parked_opt is not None:
                opt_state = parked_opt
            start = parked_step + 1
            resumed_from = parked_step

    losses: list[float] = []
    gsteps: list[int] = []
    metrics: list[float] = []
    metric_epochs: list[int] = []
    degraded_seen = 0

    def partial() -> dict:
        return {"losses": losses, "gsteps": gsteps, "metrics": metrics,
                "metric_epochs": metric_epochs,
                "degraded_seen": degraded_seen,
                "resumed_from": resumed_from, "partial": True}

    ckpt = int(getattr(cfg, "checkpoint_every", 0) or 0)
    for gstep in range(start, cfg.epochs * cfg.steps_per_epoch):
        epoch, step = divmod(gstep, cfg.steps_per_epoch)
        if inj is not None and inj.is_killed(rank, gstep, attempt):
            kill()
            return dict(partial(), killed_at=gstep)
        batches = [pipeline.batch_at(epoch, step)]
        loss, stacked = _member_grads(prob.grad_fn, params, batches)
        if inj is not None:
            stacked = inj.corrupt(stacked, rank, gstep)
        g = tree_map(lambda l: l[0], stacked)
        _straggle_sleep(inj, rank, gstep, cfg.compute_time)

        def pair(g=g, gstep=gstep):
            rkv.push("grads", g, step=gstep, unit=rank)
            return rkv.pull("grads", step=gstep, unit=rank)

        total, info = _riding(rkv, pair)
        if info.get("degraded"):
            degraded_seen += 1
        if total is not None and info["count"]:
            k = info["count"]
            params, opt_state = opt.update(_div(total, k * wpc), opt_state,
                                           params)
        losses.append(loss)
        gsteps.append(gstep)
        if step == cfg.steps_per_epoch - 1:
            metrics.append(prob.eval_fn(params))
            metric_epochs.append(epoch)
        if ckpt and (gstep + 1) % ckpt == 0:
            _park_state(cfg, rkv, rank, gstep, pspec, ospec,
                        params, opt_state)
        _progress(conn, rank, gstep)
        if flush is not None:
            flush(partial())
    return dict(partial(), partial=False)


def _run_dist_esgd(cfg, prob, rkv, conn, rank, inj, kill, *,
                   attempt: int = 0, flush=None) -> dict:
    params0 = _init_params(cfg, prob)
    _init_key(cfg, prob, rkv, conn, rank, "centers", params0)
    pipeline = prob.make_pipeline(rank)
    group = _worker_group(cfg)
    opt = _make_opt(cfg, params0)
    params = params0
    opt_state = opt.init(params0)
    pspec = flatbuf.spec_for(params0)
    ospec = _opt_spec(opt_state)

    start = 0
    resumed_from = None
    if attempt > 0:
        parked = _unpark_state(rkv, rank, pspec, ospec)
        if parked is not None:
            params, parked_opt, parked_step = parked
            if parked_opt is not None:
                opt_state = parked_opt
            start = parked_step + 1
            resumed_from = parked_step

    losses: list[float] = []
    gsteps: list[int] = []
    metrics: list[float] = []
    metric_epochs: list[int] = []
    exchanges = 0

    def partial() -> dict:
        return {"losses": losses, "gsteps": gsteps, "metrics": metrics,
                "metric_epochs": metric_epochs, "exchanges": exchanges,
                "resumed_from": resumed_from, "partial": True}

    ckpt = int(getattr(cfg, "checkpoint_every", 0) or 0)
    for it in range(start, cfg.epochs * cfg.steps_per_epoch):
        if inj is not None and inj.is_killed(rank, it, attempt):
            kill()
            return dict(partial(), killed_at=it)
        epoch = min(it // cfg.steps_per_epoch, cfg.epochs - 1)
        step = it % cfg.steps_per_epoch
        batches = [pipeline.batch_at(epoch, step)]
        loss, g = _client_grad(prob.grad_fn, params, batches, group)
        if it % cfg.esgd_interval == 0:
            pushed = params
            if inj is not None:
                pushed = inj.corrupt(pushed, rank, it)
            _straggle_sleep(inj, rank, it, cfg.compute_time)
            old_center, _info = _riding(
                rkv, lambda p=pushed, it=it: rkv.elastic_exchange(
                    "centers", p, step=it, unit=rank))
            if old_center is not None:
                exchanges += 1
                if cfg.flat_exchange:
                    params = elastic_client_packed(
                        params, old_center, cfg.esgd_alpha)
                else:
                    params = elastic_client_update(
                        params, old_center, cfg.esgd_alpha)
        params, opt_state = opt.update(g, opt_state, params)
        losses.append(loss)
        gsteps.append(it)
        if step == cfg.steps_per_epoch - 1:
            metrics.append(prob.eval_fn(
                _riding(rkv, lambda: rkv.value("centers"))))
            metric_epochs.append(epoch)
        if ckpt and (it + 1) % ckpt == 0:
            _park_state(cfg, rkv, rank, it, pspec, ospec,
                        params, opt_state)
        _progress(conn, rank, it)
        if flush is not None:
            flush(partial())
    return dict(partial(), partial=False,
                final_center_metric=float(metrics[-1]) if metrics else None)


def write_metrics(out: dict, rank: int, rendezvous_addr: str,
                  transport: str = "tcp") -> None:
    """Write a finished worker's metrics to the job's
    ``outdir/metrics_worker_<rank>.json`` (no outdir: nothing)."""
    import json

    from repro_torch.net.transport import connect_with_retry, transport_for

    conn = connect_with_retry(transport_for(transport), rendezvous_addr)
    config, _ = conn.request("config")
    conn.close()
    outdir = config.get("outdir")
    if outdir:
        path = os.path.join(outdir, f"metrics_worker_{rank}.json")
        with open(path, "w") as f:
            json.dump(_jsonable(out), f, indent=2)


def main() -> None:  # pragma: no cover - process entry
    import argparse

    ap = argparse.ArgumentParser(description="transport worker process")
    ap.add_argument("--rendezvous",
                    default=os.environ.get("REPRO_RDZV_ADDR"))
    ap.add_argument("--rank", type=int,
                    default=int(os.environ.get("REPRO_RANK", "0")))
    ap.add_argument("--transport", default="tcp")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    args = ap.parse_args()
    if not args.rendezvous:
        ap.error("--rendezvous (or REPRO_RDZV_ADDR) is required")
    attempt = int(os.environ.get("REPRO_ATTEMPT", "0"))
    out = run_worker(rank=args.rank, rendezvous_addr=args.rendezvous,
                     transport=args.transport, attempt=attempt,
                     device=args.device)
    write_metrics(out, args.rank, args.rendezvous, args.transport)


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


if __name__ == "__main__":  # pragma: no cover
    main()
