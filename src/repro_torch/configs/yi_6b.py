"""yi-6b — llama-architecture GQA model.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    block_pattern=("full",),
    norm="rms", mlp="swiglu", rope_theta=5000000.0,
    supports_long_context=False,
    notes="llama arch; GQA kv=4",
)
