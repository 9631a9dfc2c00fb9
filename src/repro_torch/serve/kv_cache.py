"""KV byte accounting shared by the paged allocator and the engine.

``kv_bytes_per_token`` sizes one token of context across all attention
layers; ``QUEUE_TOKEN_BYTES`` is what one queued prompt token holds.  Both
feed the SmartConf ``hbm_bytes`` controllers' gains, so the deputy metric
and the controller model can never drift apart.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

__all__ = ["kv_bytes_per_token", "QUEUE_TOKEN_BYTES"]

# Host+device bytes one *queued* prompt token holds (int32 token + int32
# label/scratch view).  Both the admission-queue deputy accounting in
# ``ServeEngine.submit`` and the ``serve.max_queue_tokens`` controller gain
# (alpha = bytes released per queued token shed) derive from this constant.
QUEUE_TOKEN_BYTES = 8


def kv_bytes_per_token(cfg: ArchConfig) -> int:
    """HBM bytes one token of context occupies across all layers."""
    dt = 2 if cfg.dtype == "bfloat16" else 4
    hd = cfg.resolved_head_dim
    per_layer_attn = 2 * cfg.num_kv_heads * hd * dt
    total = 0
    pattern = cfg.block_pattern
    for i in range(cfg.num_layers):
        base = pattern[i % len(pattern)].split("+")[0]
        if base in ("rwkv6", "rglru"):
            continue  # O(1) state, not per-token
        total += per_layer_attn
    return total
