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
unless the caller passes ``device="cpu"``.

  python -m repro_torch.launch.train --full-size --steps 5
"""
from __future__ import annotations

import argparse
import math
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


class _NotPorted(argparse.Action):
    """A flag of the reference's CLI whose path is not ported yet."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not yet ported (this slice runs "
                     "mpi-SGD with one client in one process)")


#: the reference CLI's flags for paths later slices port: (flag, takes a value)
_UNPORTED_FLAGS = (
    ("--shape", True), ("--client", True), ("--num-clients", True),
    ("--scheduler", True), ("--no-fused-update", False),
    ("--flat-exchange", False), ("--no-flat-exchange", False),
    ("--bucket-bytes", True), ("--wire-dtype", True), ("--overlap", False),
    ("--overlap-buckets", True), ("--allreduce", True), ("--num-rings", True),
    ("--policy", True), ("--tune-p", True), ("--faults", True),
    ("--barrier-timeout", True), ("--transport", True),
    ("--rendezvous", True), ("--mode", True), ("--problem", True),
    ("--mesh", True),
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="mpi-SGD training worker (PyTorch port, one client)")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--optimizer", default="sgd",
                    choices=("sgd", "adagrad", "adamw"),
                    help="update rule; every choice rides the fused flat path")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--state-dtype", default="f32", choices=("f32", "bf16"),
                    help="flat optimizer-state stream dtype")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in completed steps (0 = off)")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--restore", default="",
                    help="checkpoint to restore params/opt-state/step from")
    ap.add_argument("--full-size", action="store_true",
                    help="full architecture (default: reduced smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    for flag, takes_value in _UNPORTED_FLAGS:
        ap.add_argument(flag, action=_NotPorted, nargs=None if takes_value else 0,
                        help=argparse.SUPPRESS)
    return ap


def main(argv: Optional[list] = None) -> list:
    from repro_torch.configs.base import TrainSettings, get_config, reduced
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build_model

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    settings = TrainSettings(lr=args.lr, momentum=args.momentum,
                             optimizer_name=args.optimizer,
                             weight_decay=args.weight_decay,
                             state_dtype=args.state_dtype,
                             checkpoint_every=args.checkpoint_every,
                             restore=args.restore)
    model = build_model(cfg)
    pipe = TokenPipeline(DataConfig(
        seed=0, vocab_size=min(cfg.padded_vocab, 256), seq_len=64,
        batch_size=8, steps_per_epoch=args.steps), device=device)
    print(f"[train] arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"dtype={cfg.dtype} device={device} "
          f"optimizer={settings.optimizer_name} "
          f"state_dtype={settings.state_dtype} fused_update=True", flush=True)
    _, hist = train_loop(model, settings.optimizer(), settings.sync_config(),
                         None, pipe.epoch(0), device=device,
                         log_every=max(args.steps // 10, 1),
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
