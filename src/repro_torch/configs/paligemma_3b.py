"""PaliGemma-3B language backbone: SigLIP frontend is a STUB (patch
embeddings supplied by input_specs). [arXiv:2407.07726]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    use_rope=True,
    num_image_tokens=256,
    tie_embeddings=True,
    citation="arXiv:2407.07726 (SigLIP + Gemma)",
)
