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

    def validate(self, mesh: None = None) -> None:
        """Check the config before any step runs (``mesh=None``: the
        single-process drivers; no mesh exists in the port yet)."""
        if mesh is not None:
            raise NotImplementedError("not yet ported: device meshes")
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


def clientize(params: Any, num_clients: int) -> Any:
    """Give every client its own replica: leading dim C on every leaf."""
    if num_clients <= 1:
        return params
    return tree_map(
        lambda p: p.unsqueeze(0).expand((num_clients,) + tuple(p.shape)).clone(),
        params)


def declientize(params: Any, num_clients: int) -> Any:
    """Consensus model: mean over the client dim (end of training)."""
    if num_clients <= 1:
        return params
    return tree_map(lambda p: p.float().mean(0).to(p.dtype), params)


def should_elastic_sync(step: torch.Tensor, interval: int) -> torch.Tensor:
    return (step % interval) == 0
