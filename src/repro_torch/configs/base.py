"""Architecture and input-shape configuration (assignment spec, DESIGN.md §5).

``ArchConfig`` is the single source of truth a model is built from; one file
per assigned architecture lives next to this module.  ``ShapeConfig`` defines
the four assigned input shapes.  ``--arch <id>`` resolution happens in
:func:`repro_torch.configs.get_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # block schedule: one entry per layer *within a repeating group*.
    # kinds: full | swa | local | global | rwkv6 | rglru
    block_pattern: Tuple[str, ...] = ("full",)
    window: int = 4096           # swa/local attention window
    first_k_dense: int = 0       # MoE: leading dense-FFN layers (DeepSeek: 1)

    # normalization / mlp flavour
    norm: str = "rms"            # rms | layer
    mlp: str = "swiglu"          # swiglu | gelu
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0  # 0 -> same as rope_theta (gemma3 globals use 1e6)

    # MoE
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # routed-expert hidden dim (fine-grained MoE)
    capacity_factor: float = 1.25

    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500          # precomputed audio-frame embeddings (stub)

    # multimodal frontend stub
    frontend: str = ""           # "" | audio | vision
    num_patches: int = 0         # vision: prefix patch embeddings
    frontend_dim: int = 0        # raw embedding dim fed by the stub

    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # which assigned shapes this arch runs (long_500k only for sub-quadratic)
    supports_long_context: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return all(k in ("rwkv6",) for k in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d                       # token embedding
        if not self.tie_embeddings:
            total += v * d                  # lm head
        if self.frontend == "vision":
            total += self.frontend_dim * d + d * d   # connector MLP
        if self.encoder_decoder:
            total += self.enc_seq * 0       # frame embeddings arrive precomputed

        def attn_params() -> int:
            return d * n_q + 2 * d * n_kv + n_q * d

        def dense_mlp() -> int:
            if self.mlp == "swiglu":
                return 3 * d * self.d_ff
            return 2 * d * self.d_ff

        def moe_mlp() -> int:
            routed = self.num_experts * 3 * d * self.moe_d_ff
            shared = self.num_shared_experts * 3 * d * self.moe_d_ff
            router = d * self.num_experts
            return routed + shared + router

        def rwkv6_block() -> int:
            # time-mix (r,k,v,g,o + decay lora + bonus u) + channel-mix
            tm = 5 * d * d + 2 * d * 64 + d
            cm = 2 * d * int(self.d_ff)
            return tm + cm

        def rglru_block() -> int:
            # recurrent block: input/gate projections + RG-LRU params + out
            d_rnn = n_q
            return 2 * d * d_rnn + 3 * d_rnn + d_rnn * d

        n_layers = self.num_layers
        pattern = self.block_pattern
        per_kind = {}
        for kind in set(pattern):
            if kind == "rwkv6":
                per_kind[kind] = rwkv6_block() + dense_mlp() * 0
            elif kind == "rglru":
                per_kind[kind] = rglru_block() + dense_mlp()
            else:
                per_kind[kind] = attn_params() + dense_mlp()
        # MoE replaces the dense MLP beyond first_k_dense layers
        total_blocks = 0
        for i in range(n_layers):
            kind = pattern[i % len(pattern)]
            blk = per_kind[kind]
            if self.moe and i >= self.first_k_dense and kind not in ("rwkv6", "rglru"):
                blk = attn_params() + moe_mlp()
            total_blocks += blk
        total += total_blocks
        if self.encoder_decoder:
            # encoder blocks + decoder cross-attention
            total += self.enc_layers * (attn_params() + dense_mlp())
            total += self.num_layers * attn_params()   # cross-attn per dec layer
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        inactive = (self.num_experts - self.top_k) * 3 * d * self.moe_d_ff
        n_moe_layers = self.num_layers - self.first_k_dense
        return self.param_count() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests: few layers, narrow
    width, small vocab/experts — structure preserved."""
    pattern = cfg.block_pattern
    n_layers = max(len(pattern), 2)
    if cfg.first_k_dense:
        n_layers = max(n_layers, cfg.first_k_dense + 1)
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.num_kv_heads if cfg.num_kv_heads < cfg.num_heads else heads))
    base = dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=min(cfg.window, 32),
        moe_d_ff=32 if cfg.moe else 0,
        num_experts=min(cfg.num_experts, 8) if cfg.moe else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        enc_layers=2 if cfg.encoder_decoder else 0,
        enc_seq=24 if cfg.encoder_decoder else cfg.enc_seq,
        num_patches=8 if cfg.frontend == "vision" else 0,
        frontend_dim=32 if cfg.frontend else 0,
        dtype="float32",
    )
    return dataclasses.replace(base, **overrides) if overrides else base
