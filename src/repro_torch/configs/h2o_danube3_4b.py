"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    block_pattern=("swa",), window=4096,
    norm="rms", mlp="swiglu", rope_theta=10000.0,
    supports_long_context=True,   # all-SWA => ring KV cache, sub-quadratic
    notes="GQA kv=8; SWA window 4096",
)
