"""rwkv6-7b — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    block_pattern=("rwkv6",),
    norm="layer", mlp="gelu",      # rwkv uses LN; mlp unused (channel mix)
    supports_long_context=True,    # O(1) recurrent state
    notes="heads = d_model/64 internally; attn-free",
)
