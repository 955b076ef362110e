"""Config system: model architecture + run settings.

The port's own copy of ``repro/configs/base.py`` (which cannot be imported:
it pulls in JAX through ``repro.core.comm``). ``get_config(name)`` resolves
``configs/<id>.py``; ``reduced(cfg)`` is the CPU smoke-test variant of the
same family; ``INPUT_SHAPES`` are the reference's four workload shapes.
The port has every family of the reference: dense, MoE, SSM, hybrid,
the audio encoder-decoder (whisper) and the VLM (paligemma), ten configs.

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
    """Architecture description (the architecture fields of the
    reference's ``ModelConfig``). Frozen: derive variants with replace()."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
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
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (zamba2-style) ---
    attn_period: int = 0  # shared attention block every N backbone layers
    shared_lora_rank: int = 0
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0  # >0 => enc-dec; num_layers is decoder depth
    enc_seq_len: int = 1500  # stub audio frame count
    # --- VLM ---
    num_image_tokens: int = 0  # stub patch-embedding count
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    citation: str = ""
    # --- lowering / memory knobs (not architecture) ---
    # the reference's scan-vs-unroll switch for its layer stacks; the port
    # always loops its layers in Python, so it is accepted and has no effect
    unroll_layers: bool = False
    # Megatron-style sequence parallelism on a DTensor mesh: shard the
    # residual stream's seq dim over 'model' between blocks
    # (sharding.rules.maybe_seq_shard)
    seq_shard_activations: bool = False
    # activation checkpointing of each layer body (models/layers.remat)
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_enc_dec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: SSM, hybrid, or sliding-window attention."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), the reference's
        formula: the final norm's scale (and qk-norm's) is not counted, and
        the hybrid's LoRA term counts three (q, k, v) pairs per invocation
        although the hybrid's params hold the q pair only; the enc-dec's
        learned position tables and its layer-norm biases are not counted
        either."""
        d, v, h = self.d_model, self.padded_vocab, self.resolved_head_dim
        n = v * d if self.tie_embeddings else 2 * v * d
        attn = (d * self.num_heads * h + 2 * d * self.num_kv_heads * h
                + self.num_heads * h * d)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * h
        if self.arch_type in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            heads = di // self.ssm_head_dim
            mamba = (d * (2 * di + 2 * self.ssm_state + heads)
                     + self.ssm_conv_width * (di + 2 * self.ssm_state)
                     + di * d + 2 * heads + di)
            n += self.num_layers * (mamba + d)
            if self.arch_type == "hybrid":
                n += attn + 3 * d * self.d_ff + 2 * d  # the one shared block
                r = self.shared_lora_rank
                if self.attn_period and r:
                    n += (self.num_layers // self.attn_period) * 3 * (d * r + r * d)
            return n
        if self.arch_type == "moe":
            ffn = ((self.num_experts + self.num_shared_experts) * 3 * d
                   * self.moe_d_ff + d * self.num_experts)
        else:
            ffn = 3 * d * self.d_ff
        n += self.num_layers * (attn + ffn + 2 * d)
        if self.is_enc_dec:
            # cross-attention + encoder stack (whisper's MLP has no gate)
            n -= self.num_layers * d * self.d_ff  # dec ffn: 2dw not 3dw
            n += self.num_layers * attn
            n += self.enc_layers * (attn + 2 * d * self.d_ff + 2 * d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k routed)."""
        if self.arch_type != "moe":
            return self.param_count()
        routed = 3 * self.d_model * self.moe_d_ff
        return (self.param_count() - self.num_layers * self.num_experts * routed
                + self.num_layers * self.top_k * routed)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

#: the reference's ``ARCH_IDS``, in its order
ARCH_IDS = ["paligemma_3b", "qwen3_4b", "qwen2_moe_a2_7b", "mamba2_130m",
            "qwen2_0_5b", "whisper_base", "mixtral_8x7b", "zamba2_1_2b",
            "phi3_medium_14b", "qwen2_5_3b"]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    if _norm(name) not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.CONFIG


def list_configs() -> list[str]:
    return list(ARCH_IDS)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family, 2 layers (the hybrid 4),
    d_model<=256, <=4 experts, f32."""
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
    if cfg.arch_type == "moe":
        upd.update(num_experts=4, top_k=min(cfg.top_k, 2),
                   num_shared_experts=min(cfg.num_shared_experts, 1),
                   moe_d_ff=min(cfg.moe_d_ff, 128))
    if cfg.arch_type in ("ssm", "hybrid"):
        upd.update(ssm_state=min(cfg.ssm_state, 32), ssm_head_dim=32,
                   ssm_chunk=64)
    if cfg.arch_type == "hybrid":
        upd.update(attn_period=2, num_layers=4,
                   shared_lora_rank=min(cfg.shared_lora_rank, 8))
    if cfg.is_enc_dec:
        upd.update(enc_layers=2, enc_seq_len=64)
    if cfg.num_image_tokens:
        upd.update(num_image_tokens=16)
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
