"""recurrentgemma-9b — Griffin: RG-LRU + local attention 2:1.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "swa"), window=2048,
    norm="rms", mlp="geglu", rope_theta=10000.0,
    supports_long_context=True,    # RG-LRU state + w=2048 ring cache
    notes="MQA local attention (kv=1); 12 groups + 2 remainder rglru",
)
