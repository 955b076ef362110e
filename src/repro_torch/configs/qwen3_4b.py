"""Qwen3-4B: GQA with qk_norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    citation="hf:Qwen/Qwen3-8B",
)
