"""internvl2-1b — InternViT (stub) + Qwen2-0.5B LM backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    block_pattern=("full",),
    norm="rms", mlp="swiglu", rope_theta=1000000.0,
    frontend="vision", num_patches=256, frontend_dim=1024,
    supports_long_context=False,
    notes="patch embeddings precomputed by the stub ViT; MLP connector",
)
