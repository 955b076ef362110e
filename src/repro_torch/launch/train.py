"""Production train step + training-loop driver (``repro/launch/train.py``).

``make_train_step`` builds the step for both lowerable sync modes:

  mpi_sgd   C = 1 (``step_c1``): gradients of the model's loss, then the
            ``SyncEngine``'s update leg — on the default path the
            FlatEngine packs the gradient pytree into the persistent f32
            ``FlatBuffer``, runs ONE fused optimizer kernel over it, and
            unpacks the updated params (bf16 params are rounded back every
            step; there is no f32 master copy)
  mpi_esgd  C > 1 (``step_multiclient``): params carry a leading client
            dim; each client's grads come from its own batch slice, the
            update runs for every client at once (one kernel launch over
            the stacked buffer, each client in local p = 1 geometry), and
            every INTERVAL steps the elastic exchange (eqs. 2/3, one fused
            kernel) pulls the replicas and the center together

Entry points default to the CUDA device and raise when there is none,
unless the caller passes ``device="cpu"``. The CLI takes the reference
worker's flags and lowers them as it does (``settings_from_args``):

  python -m repro_torch.launch.train --full-size --steps 5
  python -m repro_torch.launch.train --device cpu --steps 3 --wire-dtype int8 --allreduce ring
"""
from __future__ import annotations

import argparse
import math
import os
from typing import Any, Callable, Optional

import torch

from repro_torch.core import comm as comm_lib, flatbuf
from repro_torch.core.hierarchy import SyncConfig, clientize, should_elastic_sync
from repro_torch.core.sync_engine import (
    flat_exchange_active,
    flat_update_supported,
    make_sync_engine,
)
from repro_torch.models.model import Model
from repro_torch.optim.sgd import Optimizer
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA request with no CUDA
    device raises (pass ``device="cpu"`` to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return device


def grad_spec(model: Model) -> flatbuf.FlatBuffer:
    """The persistent FlatBuffer spec of this model's gradient pytree,
    built once from shape-only (``meta``) params."""
    return flatbuf.spec_for(model.init(device="meta"))


def _engine_spec(model: Model, optimizer: Optimizer, sync: SyncConfig):
    """The FlatBuffer spec, when any flat leg will engage (else None)."""
    if flat_update_supported(optimizer, sync) or flat_exchange_active(sync):
        return grad_spec(model)
    return None


def make_train_state(model: Model, optimizer: Optimizer, sync: SyncConfig,
                     seed: int = 0, *, device="cuda", mesh=None) -> dict:
    """Initial state ``{"params", "opt", "step"}`` (+ ``"center"``, the
    center variables w̃, for mpi_esgd). On the fused path the optimizer
    state is the flat state buffer (momentum / AdaGrad accumulator /
    AdamW ``{"mv", "t"}``) in local (p=1) geometry — one per client when
    C > 1."""
    device = resolve_device(device)
    engine = make_sync_engine(optimizer, sync, mesh,
                              spec=_engine_spec(model, optimizer, sync))
    params = model.init(device=device, seed=seed)
    state = {
        "params": clientize(params, sync.num_clients),
        "opt": clientize(engine.init_opt(params), sync.num_clients),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if sync.mode == "mpi_esgd":
        state["center"] = params
    return state


def make_grad_fn(model: Model, microbatch: int = 1) -> Callable:
    """``(params, batch) -> (loss, metrics, grads)`` for one client.

    ``microbatch`` > 1 splits the batch into M accumulation steps (f32
    accumulator, mean over M, grads cast back to the param dtype)."""

    def single_grad(params, batch):
        leaves, treedef = tree_flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss, metrics = model.loss_fn(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    if microbatch <= 1:
        return single_grad
    M = microbatch

    def accum_grad(params, batch):
        B = next(iter(batch.values())).shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} microbatches")
        mb = B // M
        loss_acc, met_acc, g_acc = None, None, None
        for i in range(M):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics, grads = single_grad(params, sub)
            g_leaves = [g.float() for g in tree_flatten(grads)[0]]
            if g_acc is None:
                loss_acc, met_acc, g_acc = loss.float(), metrics, g_leaves
            else:
                loss_acc = loss_acc + loss
                met_acc = {k: met_acc[k] + v for k, v in metrics.items()}
                g_acc = [a + g for a, g in zip(g_acc, g_leaves)]
        p_leaves, treedef = tree_flatten(params)
        grads = tree_unflatten(treedef, [(g / M).to(p.dtype)
                                         for g, p in zip(g_acc, p_leaves)])
        return loss_acc / M, {k: v / M for k, v in met_acc.items()}, grads

    return accum_grad


def stacked_grads(grad_fn: Callable, params: Any, batch: dict, ndim: int = 1):
    """Run ``grad_fn`` once per member of params and batch stacked over
    ``ndim`` leading dims (clients, or emulated devices), one member at a
    time so only one member's activations are live; returns the losses
    and metrics stacked over those dims and the grads stacked as the
    params are."""
    lead = tuple(tree_flatten(params)[0][0].shape[:ndim])
    n = math.prod(lead)
    flat = lambda t: t.reshape((n,) + tuple(t.shape[ndim:]))
    p_rows = tree_map(flat, params)
    b_rows = {k: flat(v) for k, v in batch.items()}
    losses, metrics, out = [], {}, None
    for i in range(n):
        loss, met, grads = grad_fn(tree_map(lambda t: t[i], p_rows),
                                   {k: v[i] for k, v in b_rows.items()})
        if out is None:
            out = tree_map(lambda g: g.new_empty((n,) + tuple(g.shape)), grads)
        tree_map(lambda o, g: o[i].copy_(g), out, grads)
        del grads
        losses.append(loss)
        for k, v in met.items():
            metrics.setdefault(k, []).append(v)
    unflat = lambda t: t.reshape(lead + tuple(t.shape[1:]))
    return (unflat(torch.stack(losses)),
            {k: unflat(torch.stack(v)) for k, v in metrics.items()},
            tree_map(unflat, out))


def make_train_step(model: Model, optimizer: Optimizer, sync: SyncConfig,
                    mesh=None, *, microbatch: int = 1,
                    comm: comm_lib.Communicator | None = None,
                    device="cuda") -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    reference's ``step_c1`` for C = 1, ``step_multiclient`` for C > 1
    (batch leaves then carry a leading client dim C)."""
    device = resolve_device(device)
    sync.validate(mesh)
    C = sync.num_clients
    if C > 1:
        # each client updates in its local (p=1) geometry
        comm = comm.local() if comm is not None else None
    engine = make_sync_engine(optimizer, sync, mesh, comm=comm,
                              spec=_engine_spec(model, optimizer, sync))
    grad_fn = make_grad_fn(model, microbatch)

    def step_c1(state, batch):
        engine.check_opt_layout(state["opt"])
        batch = {k: v.to(device) for k, v in batch.items()}
        loss, metrics, grads = grad_fn(state["params"], batch)
        new_p, new_o = engine.update(grads, state["opt"], state["params"])
        return (
            {"params": new_p, "opt": new_o, "step": state["step"] + 1},
            {"loss": loss, **metrics},
        )

    def step_multiclient(state, batch):
        engine.check_opt_layout(state["opt"], C)
        batch = {k: v.to(device) for k, v in batch.items()}
        loss, metrics, grads = stacked_grads(grad_fn, state["params"], batch)
        new_p, new_o = engine.update(grads, state["opt"], state["params"])
        del grads
        new_state = dict(state, params=new_p, opt=new_o,
                         step=state["step"] + 1)
        # the pre-increment step gates the exchange, after the update
        if sync.mode == "mpi_esgd" and bool(
                should_elastic_sync(state["step"], sync.esgd_interval)):
            p2, c2 = engine.exchange_multiclient(
                new_state["params"], new_state["center"], sync.esgd_alpha / C)
            new_state = dict(new_state, params=p2, center=c2)
        return new_state, {"loss": loss.mean(),
                           **{k: v.mean() for k, v in metrics.items()}}

    return step_c1 if C <= 1 else step_multiclient


def train_loop(model: Model, optimizer: Optimizer, sync: SyncConfig,
               mesh, batches, *, seed: int = 0, device="cuda",
               log_every: int = 10, callback: Optional[Callable] = None,
               checkpoint_every: int = 0, checkpoint_dir: str = "",
               restore: str = "") -> tuple[dict, list]:
    """Concrete training driver. ``checkpoint_every``/``checkpoint_dir``
    write atomic checkpoints of the whole state every N completed steps;
    ``restore`` loads one and skips the steps it covers (the data is
    deterministic per step, so the resumed curve continues the
    original)."""
    from repro_torch.checkpoint import checkpoint as ckpt

    state = make_train_state(model, optimizer, sync, seed, device=device,
                             mesh=mesh)
    start = 0
    if restore:
        state, meta = ckpt.restore_checkpoint(restore, state)
        start = int(meta.get("step", 0))
    step_fn = make_train_step(model, optimizer, sync, mesh, device=device)
    history = []
    for i, batch in enumerate(batches):
        if i < start:
            continue            # covered by the restored checkpoint
        state, metrics = step_fn(state, batch)
        if i % log_every == 0:
            entry = {k: float(v) for k, v in metrics.items()}
            entry["step"] = i
            history.append(entry)
            if callback:
                callback(entry)
        if (checkpoint_every and checkpoint_dir
                and (i + 1) % checkpoint_every == 0):
            ckpt.save_checkpoint(ckpt.checkpoint_path(checkpoint_dir, i + 1),
                                 state, step=i + 1)
    return state, history


#: the reference CLI's flag values whose paths are not ported yet: (flag,
#: value) -> what is missing
_NOT_PORTED = {
    ("overlap", True): "--overlap needs backward overlap (the staged "
                       "backward with per-bucket reduce-scatter legs)",
    ("policy", "auto"): "--policy auto needs the cost-model autotuner "
                        "(launch.autotune)",
    ("transport", "tcp"): "--transport tcp needs the socket transport tier "
                          "(net/: rendezvous, workers, the socket PS)",
}


def build_parser() -> argparse.ArgumentParser:
    """The reference worker CLI's flags, defaults and choices
    (``repro/launch/train.py``), plus the port's ``--device``."""
    ap = argparse.ArgumentParser(
        description="per-client training worker (PyTorch port)")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="train_4k",
                    help="job-spec input shape id (recorded)")
    ap.add_argument("--client", type=int, default=0)
    ap.add_argument("--num-clients", type=int, default=1)
    ap.add_argument("--scheduler", default=None,
                    help="scheduler host:port from the job spec (recorded; "
                         "one process runs one client standalone)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--optimizer", default="sgd",
                    choices=("sgd", "adagrad", "adamw"),
                    help="update rule; every choice rides the fused flat "
                         "path when --fused-update is set")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--fused-update", dest="fused_update",
                    action="store_true", default=True)
    ap.add_argument("--no-fused-update", dest="fused_update",
                    action="store_false")
    ap.add_argument("--flat-exchange", dest="flat_exchange",
                    action="store_true", default=True)
    ap.add_argument("--no-flat-exchange", dest="flat_exchange",
                    action="store_false")
    ap.add_argument("--bucket-bytes", type=int, default=0)
    ap.add_argument("--wire-dtype", default="f32",
                    choices=("f32", "bf16", "int8"),
                    help="low-precision wire protocol on the ring hops "
                         "(requires a ring-family --allreduce method; "
                         "f32 = full precision)")
    ap.add_argument("--state-dtype", default="f32", choices=("f32", "bf16"),
                    help="flat optimizer-state stream dtype")
    ap.add_argument("--overlap", action="store_true", default=False,
                    help="backward-overlapped bucketed reduce-scatter "
                         "(not yet ported)")
    ap.add_argument("--overlap-buckets", type=int, default=4,
                    help="schedule buckets == backward stages")
    ap.add_argument("--allreduce", default=None,
                    choices=("psum", "ring", "multi_ring", "tree",
                             "scatter_gather"),
                    help="intra-client collective (default: psum, or ring "
                         "when --wire-dtype is low-precision)")
    ap.add_argument("--num-rings", type=int, default=0,
                    help="concurrent rings for ring-family methods "
                         "(0 = default: 2, or 1 under --overlap)")
    ap.add_argument("--policy", default=None, choices=("auto",),
                    help="'auto' ranks the collective-policy space with the "
                         "cost model (not yet ported)")
    ap.add_argument("--tune-p", type=int, default=8,
                    help="devices per client --policy auto scores the "
                         "candidates at")
    ap.add_argument("--faults", default="",
                    help="deterministic fault schedule (core/faults.py "
                         "string form, e.g. 'kill@12:unit=1'); validated "
                         "here, injected by the drivers that own a clock "
                         "(core/algorithms.py, shard_driver.drive)")
    ap.add_argument("--barrier-timeout", type=float, default=None,
                    help="seconds before the sync PS barrier releases with "
                         "the survivor group (kill/drop schedules need it)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in completed steps (0 = off)")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--restore", default="",
                    help="checkpoint to restore params/opt-state/step from")
    ap.add_argument("--full-size", action="store_true",
                    help="full architecture (default: reduced smoke config)")
    ap.add_argument("--transport", default="loopback",
                    choices=("loopback", "tcp"),
                    help="'loopback' runs the standalone in-process worker; "
                         "'tcp' (a socket transport worker) is not yet ported")
    ap.add_argument("--rendezvous", default=os.environ.get("REPRO_RDZV_ADDR"),
                    help="rendezvous host:port for --transport tcp (recorded)")
    ap.add_argument("--mode", default="",
                    help="transport algorithm mode (recorded for the spec)")
    ap.add_argument("--problem", default="logreg8",
                    help="transport training problem (recorded)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    return ap


def settings_from_args(args: argparse.Namespace):
    """Lower parsed CLI flags as the reference's ``main`` does: ->
    ``(model config, TrainSettings)``. The fault schedule is parsed here,
    so a bad one fails before any compute."""
    from repro_torch.configs.base import TrainSettings, get_config, reduced

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    method = args.allreduce or (
        "psum" if args.wire_dtype == "f32" and not args.overlap else "ring")
    pol = comm_lib.CollectivePolicy(
        method=method,
        num_rings=1 if args.overlap else (args.num_rings or 2),
        bucket_bytes=args.bucket_bytes or None,
        wire_dtype=None if args.wire_dtype == "f32" else args.wire_dtype,
        overlap=args.overlap, overlap_buckets=args.overlap_buckets)
    settings = TrainSettings(lr=args.lr, momentum=args.momentum,
                             optimizer_name=args.optimizer,
                             weight_decay=args.weight_decay,
                             fused_update=args.fused_update,
                             flat_exchange=args.flat_exchange,
                             policy=pol,
                             state_dtype=args.state_dtype,
                             faults=args.faults,
                             barrier_timeout=args.barrier_timeout,
                             checkpoint_every=args.checkpoint_every,
                             restore=args.restore)
    settings.fault_schedule()  # parse errors surface before any compute
    return cfg, settings


def main(argv: Optional[list] = None) -> list:
    """The worker: one process is one client (C = 1 inside it); the job
    spec's ``--client`` picks its data shard, the rest is recorded."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build_model

    ap = build_parser()
    args = ap.parse_args(argv)
    for (dest, value), missing in _NOT_PORTED.items():
        if getattr(args, dest) == value:
            ap.error(f"not yet ported: {missing}")
    device = resolve_device(args.device)
    cfg, settings = settings_from_args(args)
    model = build_model(cfg)
    sync = settings.sync_config()
    optimizer = settings.optimizer()
    pipe = TokenPipeline(DataConfig(
        seed=0, vocab_size=min(cfg.padded_vocab, 256), seq_len=64,
        batch_size=8, steps_per_epoch=args.steps, shard=args.client),
        device=device)
    print(f"[train] client {args.client}/{args.num_clients} arch={cfg.name} "
          f"shape={args.shape} scheduler={args.scheduler} "
          f"optimizer={settings.optimizer_name} "
          f"fused_update={settings.fused_update} "
          f"bucket_bytes={settings.bucket_bytes} "
          f"wire_dtype={settings.wire_dtype} "
          f"state_dtype={settings.state_dtype} "
          f"overlap={settings.overlap} "
          f"overlap_buckets={settings.overlap_buckets} "
          f"faults={settings.faults!r} "
          f"barrier_timeout={settings.barrier_timeout} "
          f"device={device}", flush=True)
    _, hist = train_loop(model, optimizer, sync, None, pipe.epoch(0),
                         device=device, log_every=max(args.steps // 10, 1),
                         checkpoint_every=settings.checkpoint_every,
                         checkpoint_dir=args.checkpoint_dir,
                         restore=settings.restore)
    for entry in hist:
        print(f"step {entry['step']:4d} loss {entry['loss']:.4f}", flush=True)
    if hist:
        print(f"[train] done: {len(hist)} log points, "
              f"final loss {hist[-1]['loss']:.4f}", flush=True)
    return hist


if __name__ == "__main__":
    main()
