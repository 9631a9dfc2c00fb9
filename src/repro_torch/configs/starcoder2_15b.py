"""starcoder2-15b — GQA + RoPE, LayerNorm/GELU coder model.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152,
    block_pattern=("full",),
    norm="layer", mlp="gelu", rope_theta=100000.0,
    supports_long_context=False,  # pure full attention: long_500k skipped
    notes="GQA kv=4; RoPE; LayerNorm + GELU MLP",
)
