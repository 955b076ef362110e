"""Multi-pod dry run (``repro/launch/dryrun.py``): trace one step of every
(arch × input shape × mesh) combination on the production layout, with
``meta`` stand-ins (no allocation), and derive the roofline terms from
the trace. Runs as its own process: it joins a "fake" world of 256 ranks
(512 with ``--mesh multipod``) as rank 0 (``launch.mesh.join_trace_world``)
and lays it out with ``make_production_mesh`` / ``make_moe_mesh``.

Every parameter, optimizer state, cache and batch leaf is a ``meta``
tensor laid out as a DTensor on the mesh (``launch.mesh.TraceMesh``), and
the step is the one a user calls — ``make_train_step(..., mesh)``,
``make_prefill_step(model, mesh)`` or ``make_serve_step(model, mesh)``.
``TraceRecorder``, a dispatch mode below DTensor, sees rank 0's local ops
and the collectives DTensor issues for them, and counts per rank:

- collectives: each ``_c10d_functional`` / ``_dtensor`` op by the
  reference's HLO kind (``all-reduce``, ``all-gather``, ...), its group
  size, operand and result bytes, the ring wire bytes of
  ``analysis.collective_cost`` (the convention ``parse_collectives``
  charges), and the bytes a gloo rank on a card stages for it through host
  memory (operands to the host, results back: what
  ``sharding.staging.StagedCollectives`` counts in ``LinkStats.by_op``);
- FLOPs: each local op through ``torch.utils.flop_counter``'s registry —
  matrix products, convolutions and attention; elementwise work counts 0;
- bytes: each local op's input plus output bytes, views excepted — the
  unfused count of what eager PyTorch moves, not XLA's fused ``bytes
  accessed``;
- memory, in ``analysis.memory_summary``'s keys: the local shards of the
  arguments (state and batch, or params, cache and tokens), of the
  outputs, and as ``temp_size_in_bytes`` the peak of the storages born
  during the step and alive at once (activations saved for the backward,
  temporaries, the outputs as they are made), tracked with finalizers.

Depth: the reference's ``cost_analysis`` ignores ``while``-loop trip
counts, so it extrapolates from two unrolled reduced depths. The port
loops its layers in Python, so the full-depth trace is already exact;
``extrapolation`` still records the reference's two depths and the values
extrapolated from them beside it. ``ModelConfig.unroll_layers`` (the
reference's scan-vs-unroll switch) has nothing to switch here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --mesh pod [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import types
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.hierarchy import SyncConfig
from repro_torch.launch import analysis
from repro_torch.launch.mesh import join_trace_world, make_moe_mesh, make_production_mesh, mesh_num_chips
from repro_torch.launch.serve import cache_specs, make_prefill_step, make_serve_step, token_specs
from repro_torch.launch.train import (
    batch_specs,
    clientize_batch_specs,
    make_train_state,
    make_train_step,
)
from repro_torch.models.model import build_model
from repro_torch.optim.sgd import sgd
from repro_torch.sharding.rules import batch_pspec, distribute, param_specs
from repro_torch.sharding.staging import COLLECTIVE_NAMESPACES, PASS_THROUGH, staged_bytes


def skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return "full-attention arch: 500k dense KV decode is out of scope (DESIGN.md §4)"
    return None


def _reduced_depths(cfg) -> tuple:
    """Two depths for the exact linear extrapolation, honoring each
    family's repeating unit (hybrid repeats per attn_period group)."""
    if cfg.arch_type == "hybrid":
        p = cfg.attn_period
        return (p, 2 * p)
    return (2, 4)


def _with_depth(cfg, L: int):
    upd = dict(num_layers=L, unroll_layers=True)
    if cfg.is_enc_dec:
        upd["enc_layers"] = L
    return dataclasses.replace(cfg, **upd)


def _tensors(tree) -> list:
    """The tensors in nested lists, tuples and dicts (a fast flatten: the
    recorder calls it on every op)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_nbytes(tree) -> int:
    """Bytes of this rank's shards of ``tree``'s tensors."""
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if hasattr(t, "to_local") else t)
    return total


@dataclasses.dataclass
class Collective:
    """One collective as rank 0 issued it."""

    op: str             # torch's op (schema name), as ``LinkStats.by_op`` keys it
    kind: str           # the reference's HLO name
    group_size: int
    operand_bytes: int
    result_bytes: int
    wire_bytes: float
    staged_bytes: int   # what a gloo rank on a card stages through host memory


class TraceRecorder(TorchDispatchMode):
    """Counts rank 0's local ops and collectives (the module docstring).
    It returns NotImplemented for DTensor types, so DTensor decomposes each
    op first and its local ops and collectives come back here, as in
    ``sharding.staging.StagedCollectives``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[Collective] = []
        self.live = 0
        self.peak = 0
        self._born: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs an op it has not seen
            # before on fake tensors of the global shape: no rank's work
            return out
        name = func._schema.name.split("::")[-1]
        if func.namespace in COLLECTIVE_NAMESPACES:
            if name not in PASS_THROUGH:
                self._collective(func, name, args, kwargs, out)
        else:
            self._local(func, name, args, kwargs, out)
        self._track(args, kwargs, out)
        return out

    def _local(self, func, name, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if func.is_view or name.startswith(("empty", "new_empty")):
            return
        self.bytes += sum(map(_nbytes, _tensors([list(args), kwargs])))
        self.bytes += sum(map(_nbytes, _tensors(out)))

    def _collective(self, func, name, args, kwargs, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group

        names = [a.name for a in func._schema.arguments]
        group = (args[names.index("group_name")] if "group_name" not in kwargs
                 else kwargs["group_name"])
        size = (group.size() if hasattr(group, "size")
                else _resolve_process_group(group).size())
        inputs = _tensors([list(args), kwargs])
        operand = sum(map(_nbytes, inputs))
        result = sum(map(_nbytes, _tensors(out)))
        kind, wire = analysis.collective_cost(name, result, size)
        self.collectives.append(Collective(name, kind, size, operand, result, wire,
                                           staged_bytes(func, operand, result)))

    def _track(self, args, kwargs, out) -> None:
        """Each output storage no input shares is born here: its bytes are
        live until a finalizer sees it freed."""
        seen = {t.untyped_storage()._cdata for t in _tensors([list(args), kwargs])}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._born:
                continue
            n = st.nbytes()
            self._born[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._born.pop(key, 0)

    def counts(self) -> dict:
        """Collectives by kind, as the reference's ``collective_schedule``."""
        out: dict = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + 1
        return out

    def staged_by_op(self) -> dict:
        """Staged bytes by op, as ``LinkStats.by_op`` keys them."""
        out: dict = {}
        for c in self.collectives:
            out[c.op] = out.get(c.op, 0) + c.staged_bytes
        return out


@dataclasses.dataclass
class Trace:
    """One traced step (``lower_module``'s result, where the reference's
    is a ``Lowered``): the recorder's counts, the local bytes of the
    arguments and outputs, and the seconds the trace took."""

    recorder: TraceRecorder
    argument_bytes: int
    output_bytes: int
    seconds: float


def trace_call(fn, args: tuple) -> Trace:
    """``fn(*args)`` under a fresh ``TraceRecorder``."""
    rec = TraceRecorder()
    t0 = time.perf_counter()
    with rec:
        out_bytes = _local_nbytes(fn(*args))
    return Trace(rec, _local_nbytes(args), out_bytes, time.perf_counter() - t0)


def step_and_args(cfg, shape, mesh, sync: SyncConfig, *,
                  microbatch: int = 1) -> tuple:
    """The right step for this input shape and its arguments, laid out on
    ``mesh`` (a ``TraceMesh``) as ``meta`` DTensors: ``(step, args)``."""
    model = build_model(cfg)
    dev = mesh.device
    if shape.kind == "train":
        optimizer = sgd(0.1, momentum=0.9)  # the paper's server optimizer
        state = make_train_state(model, optimizer, sync, device=dev, mesh=mesh)
        in_batch = model.input_specs(shape)
        if sync.num_clients > 1:
            in_batch = clientize_batch_specs(in_batch, sync.num_clients)
        batch = distribute(in_batch, batch_specs(model, shape, mesh, sync), mesh)
        step = make_train_step(model, optimizer, sync, mesh, device=dev,
                               microbatch=microbatch)
        return step, (state, batch)
    params = model.init(device=dev)
    params = distribute(params, param_specs(params, mesh, fsdp=sync.fsdp), mesh)
    if shape.kind == "prefill":
        in_batch = model.input_specs(shape)
        bspecs = {k: batch_pspec(mesh, v.shape[0], extra_dims=len(v.shape) - 1)
                  for k, v in in_batch.items()}
        return (make_prefill_step(model, mesh, device=dev),
                (params, distribute(in_batch, bspecs, mesh)))
    # decode
    cache = model.init_cache(shape.global_batch, shape.seq_len, dev)
    cache = distribute(cache, cache_specs(cache, mesh), mesh)
    tok = model.input_specs(shape)["tokens"]
    tok = distribute(tok, token_specs(tuple(tok.shape), mesh), mesh)
    return make_serve_step(model, mesh, device=dev), (params, cache, tok)


def lower_module(cfg, shape, mesh, sync: SyncConfig, *, microbatch: int = 1) -> Trace:
    """Trace (on ``meta`` DTensors over ``mesh``, a ``TraceMesh``) one call
    of the right step for this input shape."""
    step, args = step_and_args(cfg, shape, mesh, sync, microbatch=microbatch)
    return trace_call(step, args)


def _trace_metrics(trace: Trace) -> dict:
    """``_compile_metrics``'s keys, from a trace: per-rank FLOPs, bytes,
    collective wire bytes and counts, and the memory summary."""
    rec = trace.recorder
    mem = {"argument_size_in_bytes": trace.argument_bytes,
           "output_size_in_bytes": trace.output_bytes,
           "temp_size_in_bytes": rec.peak}
    return {
        "flops": float(rec.flops),
        "bytes": float(rec.bytes),
        "wire": float(sum(c.wire_bytes for c in rec.collectives)),
        "coll_counts": rec.counts(),
        "memory": analysis.memory_summary(types.SimpleNamespace(**mem)),
    }


def extrapolation(cfg, shape, mesh, sync: SyncConfig, *,
                  microbatch: int = 1) -> dict:
    """The reference's linear extrapolation of FLOPs, bytes and wire bytes
    to ``cfg.num_layers`` from traces at its two reduced depths. The port's
    full-depth trace needs none; FLOPs and wire bytes come out equal to it
    where the depth is a whole number of the family's repeating unit.
    Bytes do not: the backward of each layer's slice of a stacked leaf
    writes a zero-filled gradient of the whole stack, so the bytes grow
    with the square of the depth."""
    L1, L2 = _reduced_depths(cfg)
    pts = [_trace_metrics(lower_module(_with_depth(cfg, L), shape, mesh, sync,
                                       microbatch=microbatch))
           for L in (L1, L2)]
    Lfull = cfg.num_layers

    def extrap(key):
        m1, m2 = pts[0][key], pts[1][key]
        slope = (m2 - m1) / (L2 - L1)
        return m2 + slope * (Lfull - L2)

    return {
        "flops": extrap("flops"),
        "bytes": extrap("bytes"),
        "wire": extrap("wire"),
        "depths": [L1, L2],
        # the trace runs every microbatch: nothing to scale
        "microbatch_scale": 1,
    }


def lower_one(arch: str, shape_name: str, mesh, sync_mode: str,
              *, esgd_interval: int = 64, verbose: bool = True,
              seq_shard: bool = False, microbatch: int = 1,
              remat: bool = True, extrapolate: bool = True,
              fsdp: bool = False, link_bw: float | None = None,
              peak_flops: float = analysis.PEAK_FLOPS,
              hbm_bw: float = analysis.HBM_BW) -> dict:
    """The reference's result dict for one combo. ``lower_s`` is the
    trace's seconds, ``compile_s`` 0 (nothing is compiled). The roofline's
    rates are the card's data sheet's (``analysis``); without ``link_bw``
    (bytes/s a link) the collective term is None and ``dominant`` is taken
    over the other two."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, seq_shard_activations=seq_shard,
                              remat=remat)
    shape = INPUT_SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": dict(mesh.shape),
                "skipped": reason}

    chips = mesh_num_chips(mesh)
    num_clients = mesh.shape.get("pod", 1) if sync_mode == "mpi_esgd" else 1
    sync = SyncConfig(mode=sync_mode, num_clients=num_clients,
                      esgd_interval=esgd_interval, fsdp=fsdp)
    sync.validate(mesh)

    # 1) the full-depth step: memory, the collective schedule, the counts
    trace = lower_module(cfg, shape, mesh, sync, microbatch=microbatch)
    t_lower = trace.seconds
    prod = _trace_metrics(trace)
    del trace

    # 2) the reference's depth extrapolation, beside the exact full trace
    extra = (extrapolation(cfg, shape, mesh, sync, microbatch=microbatch)
             if extrapolate else {})

    flops, bytes_, wire = prod["flops"], prod["bytes"], prod["wire"]

    if shape.kind == "train":
        if cfg.is_enc_dec:
            model_flops = analysis.enc_dec_model_flops(
                cfg, shape.global_batch, shape.seq_len, train=True)
        else:
            tokens = shape.global_batch * shape.seq_len
            model_flops = analysis.train_model_flops(
                cfg.param_count(), cfg.active_param_count(), tokens)
    elif shape.kind == "prefill":
        if cfg.is_enc_dec:
            model_flops = analysis.enc_dec_model_flops(
                cfg, shape.global_batch, shape.seq_len, train=False)
        else:
            tokens = shape.global_batch * shape.seq_len
            model_flops = 2.0 * cfg.active_param_count() * tokens
    else:
        model_flops = analysis.decode_model_flops(
            cfg.active_param_count(), shape.global_batch)

    coll = analysis.CollectiveStats(counts=prod["coll_counts"], wire_bytes=wire)
    roof = analysis.roofline_from_analysis(
        {"flops": flops, "bytes accessed": bytes_}, coll, chips, model_flops,
        link_bw=link_bw, peak_flops=peak_flops, hbm_bw=hbm_bw)

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": dict(mesh.shape),
        "sync": sync_mode,
        "chips": chips,
        "opts": {"seq_shard": seq_shard, "microbatch": microbatch,
                 "remat": remat, "fsdp": fsdp},
        "lower_s": round(t_lower, 1),
        "compile_s": 0.0,
        "memory": prod["memory"],
        "collective_schedule": prod["coll_counts"],
        "extrapolation": extra,
        "roofline": roof.to_dict(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if verbose:
        mem = prod["memory"]
        bpd = mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)
        x = ("n/a" if roof.collective_s is None
             else f"{roof.collective_s * 1e3:.2f}ms")
        print(
            f"[dryrun] {arch} × {shape_name} × {chips}c ({sync_mode}"
            f"{', mb=' + str(microbatch) if microbatch > 1 else ''}"
            f"{', sp' if seq_shard else ''}): "
            f"lower {t_lower:.1f}s compile 0s | "
            f"bytes/dev {bpd/1e9:.2f}GB | dominant={roof.dominant} "
            f"(c={roof.compute_s*1e3:.2f}ms m={roof.memory_s*1e3:.2f}ms "
            f"x={x}) useful={roof.useful_flops_ratio:.2f}",
            flush=True,
        )
    return result


def main(argv: list | None = None) -> int:
    """The CLI: trace the combos, write ``--out``, leave the fake world;
    -> 1 if any combo failed, else 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--sync", default=None,
                    help="mpi_sgd | mpi_esgd (default: sgd on pod, esgd on multipod)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--moe-mesh", action="store_true",
                    help="expert-parallel pod variant (data=16, expert=8, tp=2)")
    ap.add_argument("--link-bw", type=float, default=None,
                    help="bytes/s a link, for the collective term (none by default)")
    args = ap.parse_args(argv)

    multi_pod = args.mesh == "multipod"
    join_trace_world(512 if multi_pod else 256)
    if args.moe_mesh:
        mesh = make_moe_mesh(multi_pod=multi_pod, device="meta")
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    sync = args.sync or ("mpi_esgd" if multi_pod else "mpi_sgd")

    combos = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                combos.append((arch.replace("_", "-"), shape))
    else:
        combos.append((args.arch, args.shape))

    results = []
    for arch, shape in combos:
        try:
            results.append(lower_one(
                arch, shape, mesh, sync,
                seq_shard=args.seq_shard, microbatch=args.microbatch,
                remat=not args.no_remat,
                extrapolate=not args.no_extrapolate, fsdp=args.fsdp,
                link_bw=args.link_bw,
            ))
        except Exception as e:  # a failure here is a bug in the port
            import traceback

            traceback.print_exc()
            print(f"[dryrun] FAILED {arch} × {shape}: {type(e).__name__}: {e}",
                  flush=True)
            results.append({"arch": arch, "shape": shape,
                            "mesh": dict(mesh.shape), "error": str(e)})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    torch.distributed.destroy_process_group()
    failed = [r for r in results if "error" in r]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
