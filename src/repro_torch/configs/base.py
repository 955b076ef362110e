"""Config system: model architecture + run settings.

The port's own copy of ``repro/configs/base.py`` (which cannot be imported:
it pulls in JAX through ``repro.core.comm``). ``get_config(name)`` resolves
``configs/<id>.py``; ``reduced(cfg)`` is the CPU smoke-test variant of the
same family. Slice 1 ports the dense family; other families raise.

``TrainSettings`` is the run-settings half: optimizer hyperparameters, the
gradient-sync and elastic knobs, the fault schedule and checkpointing,
lowered to a ``SyncConfig`` + optimizer pair as the reference lowers them.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import InitVar, dataclass, field
from typing import Optional

import torch

from repro_torch.core.comm import CollectivePolicy, filter_mirrors, resolve_policy

#: the flat-field defaults TrainSettings ships — the base point the
#: deprecation shim resolves non-default flat kwargs against
_TRAIN_BASE = CollectivePolicy(method="psum", num_rings=2)

VOCAB_PAD = 256  # pad vocab so a 16-way model axis always divides embeddings


def pad_vocab(v: int, multiple: int = VOCAB_PAD) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (the dense-family fields of the
    reference's ``ModelConfig``). Frozen: derive variants with replace()."""

    name: str
    arch_type: str  # slice 1: "dense"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


ARCH_IDS = ["qwen2_0_5b"]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    if _norm(name) not in ARCH_IDS:
        raise NotImplementedError(
            f"not yet ported: architecture {name!r} (slice 1 ports the "
            f"dense family: {ARCH_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family, 2 layers, d_model<=256, f32."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"not yet ported: {cfg.arch_type} family")
    d = min(cfg.d_model, 256)
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    hd = max(16, d // heads)
    upd = dict(
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 1024),
        dtype="float32",
    )
    if cfg.sliding_window:
        upd.update(sliding_window=64)
    return dataclasses.replace(cfg, **upd)


@dataclass(frozen=True)
class TrainSettings:
    """Run settings: what a job spec ships alongside the architecture.

    The collective policy is ONE ``CollectivePolicy`` (``policy=`` in,
    ``.policy`` out); the flat fields mirror it. ``sync_config()`` lowers
    the policy object straight into ``SyncConfig(policy=...)``.
    """

    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    optimizer_name: str = "sgd"     # "sgd" | "adagrad" | "adamw"
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    adagrad_eps: float = 1e-10
    sync_mode: str = "mpi_sgd"      # "mpi_sgd" | "mpi_esgd"
    num_clients: int = 1
    esgd_alpha: float = 0.5
    esgd_interval: int = 64
    allreduce_method: str = "psum"
    num_rings: int = 2
    fused_update: bool = True
    # the ESGD exchange packed through the FlatBuffer and one fused kernel
    flat_exchange: bool = True
    bucket_bytes: Optional[int] = None
    wire_dtype: str = "f32"
    # flat optimizer-state stream dtype ("f32" | "bf16"); for SGD a bf16
    # momentum keeps the per-leaf path that honors it
    state_dtype: str = "f32"
    # params sharded over 'data' on a mesh (no mesh in the port: carried)
    fsdp: bool = False
    overlap: bool = False
    overlap_buckets: int = 4
    microbatch: int = 1
    # deterministic fault schedule (core/faults.py string form); "" = clean
    faults: str = ""
    # seconds before the sync PS barrier releases with the survivor group
    # (None blocks forever; kill/drop schedules need it)
    barrier_timeout: Optional[float] = None
    checkpoint_every: int = 0
    restore: str = ""
    policy_src: Optional[CollectivePolicy] = field(
        default=None, repr=False, compare=False)
    policy: InitVar[Optional[CollectivePolicy]] = None

    def __post_init__(self, policy: Optional[CollectivePolicy]) -> None:
        defaults = {"method": "psum", "num_rings": 2, "bucket_bytes": None,
                    "wire_dtype": "f32", "overlap": False,
                    "overlap_buckets": 4}
        flat = {
            "method": self.allreduce_method, "num_rings": self.num_rings,
            "bucket_bytes": self.bucket_bytes, "wire_dtype": self.wire_dtype,
            "overlap": self.overlap, "overlap_buckets": self.overlap_buckets,
        }
        flat = filter_mirrors(flat, defaults=defaults, prior=self.policy_src)
        if policy is None and flat.get("overlap"):
            flat["num_rings"] = 1  # overlap forces a single ring schedule
        pol = resolve_policy(policy, flat, base=_TRAIN_BASE,
                             where="TrainSettings")
        object.__setattr__(self, "policy", pol)
        object.__setattr__(self, "policy_src", pol)
        object.__setattr__(self, "allreduce_method", pol.method)
        object.__setattr__(self, "num_rings", pol.num_rings)
        object.__setattr__(self, "bucket_bytes", pol.bucket_bytes)
        object.__setattr__(self, "wire_dtype", pol.wire_dtype or "f32")
        object.__setattr__(self, "overlap", pol.overlap)
        object.__setattr__(self, "overlap_buckets", pol.overlap_buckets)

    def fault_schedule(self, seed: int = 0):
        """The parsed ``core.faults.FaultSchedule`` (None when clean)."""
        from repro_torch.core.faults import as_schedule

        return as_schedule(self.faults or None, seed)

    def sync_config(self):
        from repro_torch.core.hierarchy import SyncConfig

        return SyncConfig(
            mode=self.sync_mode, num_clients=self.num_clients,
            esgd_alpha=self.esgd_alpha, esgd_interval=self.esgd_interval,
            fused_update=self.fused_update, flat_exchange=self.flat_exchange,
            fsdp=self.fsdp, policy=self.policy,
        )

    def _state_dtype(self) -> Optional[torch.dtype]:
        if self.state_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"state_dtype must be f32/bf16, got {self.state_dtype!r}")
        return None if self.state_dtype == "f32" else torch.bfloat16

    def optimizer(self):
        from repro_torch.optim.sgd import adagrad, adamw, sgd

        sd = self._state_dtype()
        if self.optimizer_name == "adagrad":
            if self.weight_decay:
                raise ValueError(
                    "adagrad has no weight-decay form here; drop "
                    "--weight-decay or pick sgd/adamw")
            return adagrad(self.lr, eps=self.adagrad_eps, state_dtype=sd)
        if self.optimizer_name == "adamw":
            return adamw(self.lr, b1=self.adam_b1, b2=self.adam_b2,
                         eps=self.adam_eps, weight_decay=self.weight_decay,
                         state_dtype=sd)
        if self.optimizer_name != "sgd":
            raise ValueError(
                f"optimizer_name must be sgd/adagrad/adamw, "
                f"got {self.optimizer_name!r}")
        return sgd(self.lr, momentum=self.momentum,
                   weight_decay=self.weight_decay, state_dtype=sd)
