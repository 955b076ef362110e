"""Optimizers, pure-pytree (init/update): SGD (+momentum), AdaGrad and
AdamW, as the paper ships them to the PS via ``KVStore.set_optimizer``.

Beyond the per-leaf optimizers, this module owns the **fused flat step**
(``scatter_update_gather``): pack the gradient pytree into the FlatBuffer,
run ONE hand-written fused optimizer kernel — momentum SGD, AdaGrad or
AdamW (``FLAT_STATE_STREAMS``) — on this device's shard, and unpack the
updated params, with the ring reduce-scatter and allgather over the
gradient Communicator between them when the group has p > 1 members.
Stacked inputs (a leading device or client dim on every leaf, as the
shard driver and the multi-client step hold them) run the same way, with
ONE kernel launch over the whole stacked buffer.

``overlap_update`` is the update half of the backward-overlapped step:
the grad fn has already reduce-scattered each schedule bucket, and the
same fused kernel runs ONCE over the bucket-major schedule shard
(``optstate_sched_init`` lays its state out).
"""
from __future__ import annotations

import math
import types
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.core import comm as comm_lib, flatbuf
from repro_torch.kernels.fused_optim.fused_optim import adagrad_flat, adamw_flat
from repro_torch.kernels.fused_sgd.fused_sgd import sgd_momentum_flat
from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (g, state, p) -> (new_p, state)
    # static metadata (name + hyperparams) so drivers can lower an
    # optimizer onto its fused-kernel equivalent
    hyper: Mapping = types.MappingProxyType({})


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
        state_dtype: torch.dtype | None = None) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(
            lambda p: torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                                  device=p.device), params)

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), ()
        # f32 momentum arithmetic, rounded to the declared state dtype
        # only at the store
        hp_v = tree_map(lambda v, g: momentum * v.float() + g.float(),
                        state, grads)
        new_p = tree_map(lambda p, v: (p.float() - lr * v).to(p.dtype),
                         params, hp_v)
        new_v = tree_map(lambda v, s: v.to(s.dtype), hp_v, state)
        return new_p, new_v

    return Optimizer(init, update,
                     {"name": "sgd", "lr": lr, "momentum": momentum,
                      "weight_decay": weight_decay,
                      "state_dtype": state_dtype})


def adagrad(lr: float, eps: float = 1e-10,
            state_dtype: torch.dtype | None = None) -> Optimizer:
    sd = state_dtype or torch.float32

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=sd,
                                              device=p.device), params)

    def update(grads, state, params):
        hp_s = tree_map(lambda s, g: s.float() + torch.square(g.float()),
                        state, grads)
        new_p = tree_map(
            lambda p, g, s: (p.float() - lr * g.float()
                             / (torch.sqrt(s) + eps)).to(p.dtype),
            params, grads, hp_s)
        return new_p, tree_map(lambda s: s.to(sd), hp_s)

    return Optimizer(init, update,
                     {"name": "adagrad", "lr": lr, "eps": eps,
                      "state_dtype": state_dtype})


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          state_dtype: torch.dtype | None = None) -> Optimizer:
    sd = state_dtype or torch.float32

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=sd, device=p.device)
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_.float() + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_.float()
                     + (1 - b2) * torch.square(g.float()), state["v"], grads)
        tf = t.float()
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=tf.device), tf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=tf.device), tf)

        def step(p, m_, v_):
            upd = (m_ / c1) / (torch.sqrt(v_ / c2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new_p = tree_map(step, params, m, v)
        cast = lambda tree: tree_map(lambda leaf: leaf.to(sd), tree)
        return new_p, {"m": cast(m), "v": cast(v), "t": t}

    return Optimizer(init, update,
                     {"name": "adamw", "lr": lr, "b1": b1, "b2": b2,
                      "eps": eps, "weight_decay": weight_decay,
                      "state_dtype": state_dtype})


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "adagrad": adagrad, "adamw": adamw}[name](lr, **kw)


# ---------------------------------------------------------------------------
# Fused flat step: pack -> fused kernel on this device's shard -> unpack
# ---------------------------------------------------------------------------

#: optimizers the flat fused path lowers, with their full-length state
#: stream counts: sgd 1 (momentum), adagrad 1 (accumulator), adamw 2 (m, v)
#: plus the scalar step count t
FLAT_STATE_STREAMS: Mapping[str, int] = types.MappingProxyType(
    {"sgd": 1, "adagrad": 1, "adamw": 2})


def _flat_name(hyper) -> str:
    """Canonical optimizer family of a hyper dict (``flat_*`` aliases map
    onto their per-leaf family)."""
    name = hyper if isinstance(hyper, str) else hyper["name"]
    return name[5:] if name.startswith("flat_") else name


def state_stream_dtype(hyper, state_dtypes=None) -> torch.dtype:
    """The dtype the flat state streams are stored in: an explicit
    ``state_dtypes`` wins, else ``hyper["state_dtype"]``, else f32. The
    kernels compute in f32 and round on store either way."""
    sd = state_dtypes
    if sd is None and not isinstance(hyper, str):
        sd = hyper.get("state_dtype")
    return sd if sd is not None else torch.float32


def momentum_shard_init(spec: flatbuf.FlatBuffer, p: int = 1,
                        num_rings: int = 1,
                        bucket_bytes: int | None = None,
                        dtype: torch.dtype = torch.float32, *,
                        device=None) -> torch.Tensor:
    """Zero momentum for one device's shard of the flat buffer (p = 1 for
    the local path)."""
    return torch.zeros((flatbuf.shard_size(spec, p, num_rings, bucket_bytes),),
                       dtype=dtype, device=device)


def optstate_shard_init(hyper, spec: flatbuf.FlatBuffer, p: int = 1,
                        num_rings: int = 1,
                        bucket_bytes: int | None = None,
                        state_dtypes=None, *, device=None) -> Any:
    """Zero flat optimizer state for one device's 1/p shard:

      sgd      (n,) momentum
      adagrad  (n,) accumulator
      adamw    {"mv": (2, n) first/second moments,
                "t":  ()     i32 step count (bias correction)}
    """
    name = _flat_name(hyper)
    sd = state_stream_dtype(hyper, state_dtypes)
    n = flatbuf.shard_size(spec, p, num_rings, bucket_bytes)
    k = FLAT_STATE_STREAMS[name]
    if name == "adamw":
        return {"mv": torch.zeros((k, n), dtype=sd, device=device),
                "t": torch.zeros((), dtype=torch.int32, device=device)}
    return torch.zeros((n,), dtype=sd, device=device)


def flat_hp(hyper, device) -> torch.Tensor:
    """The step-invariant f32 hyperparameter vector a fused kernel reads:
    (lr, µ) for sgd, (lr, eps) for adagrad, (lr, b1, b2, eps, wd) for
    adamw (its c1, c2 are appended per step on the device)."""
    name = _flat_name(hyper)
    if name == "sgd":
        vals = (hyper["lr"], hyper["momentum"])
    elif name == "adagrad":
        vals = (hyper["lr"], hyper.get("eps", 1e-10))
    elif name == "adamw":
        vals = (hyper["lr"], hyper.get("b1", 0.9), hyper.get("b2", 0.95),
                hyper.get("eps", 1e-8), hyper.get("weight_decay", 0.0) or 0.0)
    else:
        raise ValueError(
            f"flat fused update knows {sorted(FLAT_STATE_STREAMS)}, got {name!r}")
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _fused_shard_update(name: str, hp: torch.Tensor, p_shard: torch.Tensor,
                        opt_state: Any, g_shard: torch.Tensor
                        ) -> tuple[torch.Tensor, Any]:
    """Launch the ONE fused update on this shard (or on every stacked
    member's shard at once): the K state streams ride the same pass as
    (param, grad)."""
    shape = p_shard.shape
    if name in ("sgd", "adagrad"):
        kernel = sgd_momentum_flat if name == "sgd" else adagrad_flat
        new_p, new_s = kernel(p_shard.reshape(-1), opt_state.reshape(-1),
                              g_shard.reshape(-1), hp)
        return new_p.view(shape), new_s.view(shape)
    if name == "adamw":
        t = opt_state["t"] + 1
        # every stacked member steps together: one t, one hp for all rows;
        # bias corrections on the device, no host sync per step
        c = 1.0 - torch.pow(hp[1:3], t.reshape(-1)[0].float())
        rows, n = math.prod(shape[:-1]), shape[-1]   # one row per member
        new_p, new_mv = adamw_flat(
            p_shard.reshape(rows, n), opt_state["mv"].reshape(rows, 2, n),
            g_shard.reshape(rows, n), torch.cat([hp, c]))
        return new_p.view(shape), {"mv": new_mv.view(opt_state["mv"].shape),
                                   "t": t}
    raise ValueError(
        f"flat fused update knows {sorted(FLAT_STATE_STREAMS)}, got {name!r}")


def scatter_update_gather(spec: flatbuf.FlatBuffer, grads: Any, params: Any,
                          opt_state: Any, lr=None, momentum=None, *,
                          hyper: Optional[Mapping] = None,
                          comm=None,
                          weight_decay: float = 0.0,
                          mean: bool = True,
                          hp: Optional[torch.Tensor] = None
                          ) -> tuple[Any, Any]:
    """One fused sync+update step:

      1. pack grads and params into the persistent flat buffer
      2. p > 1: ring reduce-scatter the grads over ``comm`` (each member
         owns a fully-reduced 1/p shard) and select the matching param
         shard
      3. ONE fused optimizer kernel over (param shard, state shard(s),
         grad shard)
      4. p > 1: ring allgather the updated param shards; unpack

    ``comm`` is the gradient group; its policy supplies the ring count,
    bucketing and the wire protocol. Under emulation the params, grads
    and state carry the world's leading device dims. ``hyper`` selects
    the optimizer (sgd / adagrad / adamw); the positional
    ``lr``/``momentum`` form is the momentum-SGD shorthand. ``hp`` is the
    cached ``flat_hp`` vector on the device (built here when omitted).
    Returns ``(new_params_tree, new_opt_state_shard)``.
    """
    if hyper is None:
        hyper = {"name": "sgd", "lr": lr, "momentum": momentum,
                 "weight_decay": weight_decay}
    elif lr is not None or momentum is not None or weight_decay:
        raise ValueError(
            "pass hyperparameters either positionally (the momentum-SGD "
            "shorthand) or via hyper=, not both")
    name = _flat_name(hyper)
    comm = comm_lib.LOCAL if comm is None else comm

    p = comm.resolve_size()
    nr = comm.rings_for(spec.nbytes)
    _, total = flatbuf.shard_geometry(spec.size, p, nr)

    g_shard = flatbuf.pack_padded(spec, grads, total)
    p_shard = flatbuf.pack_padded(spec, params, total)
    if p > 1:
        g_shard = comm.reduce_scatter(g_shard, num_rings=nr)
        p_shard = comm.shard_select(p_shard, num_rings=nr)
        if mean:
            g_shard = g_shard / p
    wd = hyper.get("weight_decay", 0.0) or 0.0
    if name == "sgd" and wd:
        # coupled L2, as per-leaf sgd; adamw decays decoupled in its kernel
        g_shard = g_shard + wd * p_shard

    if hp is None:
        hp = flat_hp(hyper, p_shard.device)
    new_p_shard, new_state = _fused_shard_update(
        name, hp, p_shard, opt_state, g_shard)
    del g_shard, p_shard
    new_p = (comm.allgather(new_p_shard, num_rings=nr) if p > 1
             else new_p_shard)
    return spec.unpack(new_p[..., :spec.size]), new_state


def optstate_sched_init(hyper, schedule: flatbuf.BucketSchedule,
                        state_dtypes=None, *, device=None) -> Any:
    """``optstate_shard_init`` for the overlapped (schedule-bucketed)
    layout: the per-device state length is ``schedule.shard_size`` — the
    bucket-major concat of single-ring per-bucket chunks — instead of the
    monolithic ``flatbuf.shard_size`` geometry."""
    name = _flat_name(hyper)
    sd = state_stream_dtype(hyper, state_dtypes)
    n = schedule.shard_size
    k = FLAT_STATE_STREAMS[name]
    if name == "adamw":
        return {"mv": torch.zeros((k, n), dtype=sd, device=device),
                "t": torch.zeros((), dtype=torch.int32, device=device)}
    return torch.zeros((n,), dtype=sd, device=device)


def overlap_update(schedule: flatbuf.BucketSchedule, g_shard: torch.Tensor,
                   staged_params: Any, opt_state: Any, *,
                   hyper: Mapping,
                   comm=None,
                   num_rings: Optional[int] = None,
                   bucket_bytes: int | None = None,
                   wire_dtype: Optional[str] = None,
                   mean: bool = True,
                   hp: Optional[torch.Tensor] = None) -> tuple[Any, Any]:
    """The update half of the backward-overlapped step.

    The grad fn already issued each schedule bucket's reduce-scatter leg
    mid-backward (``Communicator.reduce_scatter_bucket``) and hands over
    ``g_shard``: the bucket-major ``(…, schedule.shard_size)`` concat of
    each device's fully-reduced per-bucket chunks. What is left:

      1. select each device's matching param shard from the packed staged
         params (``shard_select_sched``: static, no communication)
      2. ONE fused optimizer kernel over the whole shard, every stacked
         device at once (the buckets share the launch; only the WIRE was
         bucketed)
      3. the ONE trailing allgather of the updated shard
         (``allgather_sched``), re-stitched to the packed layout

    ``staged_params`` is the stage-subtree tuple of the same
    ``overlap_stages`` split the schedule was built from; the return is
    ``(new_staged_params, new_opt_state)``. ``comm`` carries the whole
    policy: explicit ``num_rings`` / ``bucket_bytes`` / ``wire_dtype``
    would desync the wire legs from the schedule layout and are refused.
    ``hp`` is the cached ``flat_hp`` vector (built here when omitted).
    """
    if num_rings is not None or bucket_bytes is not None \
            or wire_dtype is not None:
        raise ValueError(
            "overlap_update: the bucket/ring/wire policy lives on the "
            "communicator and the BucketSchedule — set wire_dtype on the "
            "comm (Communicator.with_policy) and the bucket split via "
            "overlap_buckets, not as arguments; explicit knobs here "
            "would desync the wire legs from the schedule layout")
    comm = comm_lib.LOCAL if comm is None else comm
    name = _flat_name(hyper)
    p = comm.resolve_size()
    if p != schedule.p:
        raise ValueError(
            f"schedule was built for p={schedule.p} shards but the "
            f"communicator spans {p} — rebuild the BucketSchedule with "
            f"the gradient group's size (bucket_schedule(spec, counts, "
            f"p={p}))")

    p_shard = comm.shard_select_sched(schedule.spec.pack(staged_params),
                                      schedule)
    if mean and p > 1:
        g_shard = g_shard / p
    wd = hyper.get("weight_decay", 0.0) or 0.0
    if name == "sgd" and wd:
        g_shard = g_shard + wd * p_shard

    if hp is None:
        hp = flat_hp(hyper, p_shard.device)
    new_p_shard, new_state = _fused_shard_update(
        name, hp, p_shard, opt_state, g_shard)
    del g_shard, p_shard
    new_pbuf = comm.allgather_sched(new_p_shard, schedule)
    return schedule.spec.unpack(new_pbuf), new_state


def _flat_optimizer(hyper: dict, spec: flatbuf.FlatBuffer,
                    num_rings: int, bucket_bytes: int | None) -> Optimizer:
    """Drop-in ``Optimizer`` whose update is the fused flat-buffer kernel
    (local p=1 geometry). State is the flat stream shard(s)."""
    nr = flatbuf.effective_rings(spec.nbytes, num_rings, bucket_bytes)
    local = comm_lib.LOCAL.with_policy(num_rings=nr)

    def init(params):
        device = tree_leaves(params)[0].device
        return optstate_shard_init(hyper, spec, 1, nr, device=device)

    def update(grads, state, params):
        return scatter_update_gather(
            spec, grads, params, state, hyper=hyper, comm=local, mean=False)

    return Optimizer(init, update, hyper)


def flat_sgd(lr: float, momentum: float, spec: flatbuf.FlatBuffer, *,
             weight_decay: float = 0.0, num_rings: int = 1,
             bucket_bytes: int | None = None) -> Optimizer:
    """Fused flat momentum SGD: state is ONE flat momentum buffer."""
    return _flat_optimizer(
        {"name": "flat_sgd", "lr": lr, "momentum": momentum,
         "weight_decay": weight_decay}, spec, num_rings, bucket_bytes)


def flat_adagrad(lr: float, spec: flatbuf.FlatBuffer, *,
                 eps: float = 1e-10, num_rings: int = 1,
                 bucket_bytes: int | None = None,
                 state_dtype: torch.dtype | None = None) -> Optimizer:
    """Fused flat AdaGrad: state is ONE flat accumulator buffer."""
    return _flat_optimizer(
        {"name": "flat_adagrad", "lr": lr, "eps": eps,
         "state_dtype": state_dtype}, spec, num_rings, bucket_bytes)


def flat_adamw(lr: float, spec: flatbuf.FlatBuffer, *,
               b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.0, num_rings: int = 1,
               bucket_bytes: int | None = None,
               state_dtype: torch.dtype | None = None) -> Optimizer:
    """Fused flat AdamW: state is the (2, n) m/v buffer + scalar step."""
    return _flat_optimizer(
        {"name": "flat_adamw", "lr": lr, "b1": b1, "b2": b2, "eps": eps,
         "weight_decay": weight_decay, "state_dtype": state_dtype},
        spec, num_rings, bucket_bytes)
