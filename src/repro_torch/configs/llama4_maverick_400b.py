"""llama4-maverick-400b-a17b — interleaved dense/MoE, 128 experts top-1
plus shared expert.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    block_pattern=("full", "full+moe"),     # MoE every other layer
    norm="rms", mlp="swiglu", rope_theta=500000.0,
    moe=True, num_experts=128, num_shared_experts=1, top_k=1, moe_d_ff=8192,
    supports_long_context=False,
    notes="early-fusion multimodal in the real model; LM backbone here",
)
