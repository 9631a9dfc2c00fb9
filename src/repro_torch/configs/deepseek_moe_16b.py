"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6,
first layer dense.  [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944,                    # layer-0 dense FFN width (real model)
    vocab_size=102400,
    block_pattern=("full+moe",), first_k_dense=1,
    norm="rms", mlp="swiglu", rope_theta=10000.0,
    moe=True, num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    supports_long_context=False,
    notes="assignment d_ff=1408 is the routed-expert width",
)
