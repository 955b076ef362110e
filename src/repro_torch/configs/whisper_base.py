"""Whisper-base: enc-dec; mel+conv frontend is a STUB (frame embeddings
supplied by input_specs). 6 encoder + 6 decoder layers. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    use_rope=False,  # learned absolute positions
    enc_layers=6,
    enc_seq_len=1500,
    citation="arXiv:2212.04356",
)
