"""Client ↔ device mapping: the paper's ``#clients`` knob.

C = 1 is the pure-MPI mode (mpi-SGD): one communicator, gradients fully
reduced every step. C > 1 is mpi-ESGD: params carry a leading client dim
(one replica per client), each client syncs its gradients inside its own
group, and every INTERVAL steps the elastic exchange crosses clients.
"""
from __future__ import annotations

import dataclasses
from dataclasses import InitVar, dataclass
from typing import Any, Optional

import torch

from repro_torch.core.comm import CollectivePolicy, filter_mirrors, resolve_policy
from repro_torch.sharding.rules import P, is_spec
from repro_torch.tree import tree_map

#: the flat-field defaults SyncConfig ships — the base point the
#: deprecation shim resolves non-default flat kwargs against
_SYNC_BASE = CollectivePolicy(method="psum", num_rings=2)


@dataclass(frozen=True)
class SyncConfig:
    """Production gradient-sync mode (``repro/core/hierarchy.py``).

    The collective policy is ONE ``CollectivePolicy`` (``policy=`` in,
    ``.policy`` out); the flat fields mirror it, and writing one that
    changes the policy goes through the ``resolve_policy`` shim.
    """

    mode: str = "mpi_sgd"       # "mpi_sgd" | "mpi_esgd"
    num_clients: int = 1        # C
    esgd_alpha: float = 0.5
    esgd_interval: int = 64
    # -- flat mirrors of ``policy`` ----------------------------------------
    allreduce_method: str = "psum"
    num_rings: int = 2
    # sharded fused step: pack grads into the persistent FlatBuffer, run
    # the fused optimizer kernel on this device's shard, unpack
    fused_update: bool = True
    flat_exchange: bool = True
    bucket_bytes: Optional[int] = None
    wire_dtype: Optional[str] = None
    fsdp: bool = False
    overlap: bool = False
    overlap_buckets: int = 4
    # the policy the mirrors were backfilled from (never pass it yourself)
    policy_src: Optional[CollectivePolicy] = dataclasses.field(
        default=None, repr=False, compare=False)
    policy: InitVar[Optional[CollectivePolicy]] = None

    def __post_init__(self, policy: Optional[CollectivePolicy]) -> None:
        flat = {
            "method": self.allreduce_method, "num_rings": self.num_rings,
            "bucket_bytes": self.bucket_bytes, "wire_dtype": self.wire_dtype,
            "overlap": self.overlap, "overlap_buckets": self.overlap_buckets,
        }
        flat = filter_mirrors(
            flat, defaults={k: getattr(_SYNC_BASE, k) for k in flat},
            prior=self.policy_src)
        pol = resolve_policy(policy, flat, base=_SYNC_BASE,
                             where="SyncConfig")
        object.__setattr__(self, "policy", pol)
        object.__setattr__(self, "policy_src", pol)
        object.__setattr__(self, "allreduce_method", pol.method)
        object.__setattr__(self, "num_rings", pol.num_rings)
        object.__setattr__(self, "bucket_bytes", pol.bucket_bytes)
        object.__setattr__(self, "wire_dtype", pol.wire_dtype)
        object.__setattr__(self, "overlap", pol.overlap)
        object.__setattr__(self, "overlap_buckets", pol.overlap_buckets)

    def validate(self, mesh=None) -> None:
        """Check the config against a mesh before any step runs, so a
        client-count / mesh mismatch fails here with an actionable
        message. ``mesh=None`` (the emulated drivers, one process for the
        whole world) skips the axis checks; a ``launch.mesh.Mesh`` (the
        process backend, one process per device) gets the reference's.
        The messages are the reference's, word for word."""
        if self.mode not in ("mpi_sgd", "mpi_esgd"):
            raise ValueError(f"lowerable modes are mpi_sgd/mpi_esgd, got {self.mode}")
        self.policy.validate(where="SyncConfig")
        # the reference's messages, word for word
        if self.overlap:
            if not self.fused_update:
                raise ValueError(
                    "overlap=True rides the fused flat path — the staged "
                    "grad fn hands the update ONE bucket-major shard "
                    "buffer, which only the fused Pallas kernel consumes; "
                    "set fused_update=True (per-leaf updates would need "
                    "the full gradient pytree the overlapped step never "
                    "materializes)")
            if self.mode != "mpi_sgd":
                raise ValueError(
                    f"overlap=True is the mpi_sgd (C=1) gradient leg — "
                    f"mode={self.mode!r} runs per-client local updates "
                    "(p=1 geometry, no ring leg to hide); drop overlap "
                    "or use mode='mpi_sgd'")
            if self.fsdp:
                raise ValueError(
                    "overlap=True assumes replicated params (the staged "
                    "grad fn re-stages the full param tree per device); "
                    "fsdp=True shards them over 'data' — pick one")
            if mesh is not None:
                raise ValueError(
                    "overlap=True is collective-explicit (the per-bucket "
                    "ppermute legs are issued by the traced backward, "
                    "vmap emulation or shard_map worker programs) — with "
                    "an ambient mesh GSPMD owns the gradient collectives "
                    "and would not interleave them; drop the mesh or "
                    "overlap")
        if mesh is None or self.num_clients <= 1:
            return
        C = self.num_clients
        if "pod" not in mesh.shape:
            raise ValueError(
                f"SyncConfig(num_clients={C}) needs a 'pod' mesh axis to "
                f"shard the client dim over, but the mesh only has axes "
                f"{dict(mesh.shape)} — build it with a pod axis of size "
                f"{C}, e.g. compat.make_mesh(({C}, D), ('pod', 'data')) "
                "or launch.mesh.make_production_mesh(multi_pod=True); "
                "without it the client dim cannot be laid out and the "
                "failure would otherwise surface inside shard_map as a "
                "shape error")
        if mesh.shape["pod"] != C:
            raise ValueError(
                f"SyncConfig(num_clients={C}) != 'pod' axis size "
                f"{mesh.shape['pod']} (mesh axes {dict(mesh.shape)}) — "
                "one client per pod: set num_clients to the pod axis "
                "size or rebuild the mesh with a pod axis of size "
                f"{C}")


def clientize(params: Any, num_clients: int) -> Any:
    """Give every client its own replica: leading dim C on every leaf."""
    if num_clients <= 1:
        return params
    return tree_map(
        lambda p: p.unsqueeze(0).expand((num_clients,) + tuple(p.shape)).clone(),
        params)


def clientize_specs(specs: Any, num_clients: int) -> Any:
    """Prepend the 'pod' axis to every ``sharding.P`` of a spec tree."""
    if num_clients <= 1:
        return specs
    return tree_map(lambda s: P("pod", *tuple(s)), specs, is_leaf=is_spec)


def declientize(params: Any, num_clients: int) -> Any:
    """Consensus model: mean over the client dim (end of training)."""
    if num_clients <= 1:
        return params
    return tree_map(lambda p: p.float().mean(0).to(p.dtype), params)


def grad_sync_axes(mesh, num_clients: int) -> tuple[str, ...]:
    """Axes a client's gradient allreduce runs over."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if num_clients > 1:
        axes = tuple(a for a in axes if a != "pod")
    return axes


def should_elastic_sync(step: torch.Tensor, interval: int) -> torch.Tensor:
    return (step % interval) == 0


def pod_mean(tree: Any) -> Any:
    """Cross-client average over the leading client dim, kept as a dim of
    one (the ESGD server interaction; on a DTensor whose client dim is
    sharded over 'pod', an all-reduce over 'pod'). Accumulated in f32 as
    ``declientize``."""
    return tree_map(lambda p: p.float().mean(0, keepdim=True).to(p.dtype), tree)
