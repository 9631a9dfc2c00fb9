"""gemma3-4b — 5:1 local:global attention, 262k vocab, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    head_dim=256, d_ff=10240, vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    norm="rms", mlp="geglu", rope_theta=10000.0, rope_theta_global=1000000.0,
    supports_long_context=True,   # local layers ring-cache; globals SP-shard
    notes="5:1 local(w=1024):global; theta 10k local / 1M global",
)
