"""Zamba2-1.2B: Mamba2 backbone + shared attention block with
per-invocation LoRA. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    use_rope=True,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_period=6,
    shared_lora_rank=128,
    citation="arXiv:2411.15242",
)
