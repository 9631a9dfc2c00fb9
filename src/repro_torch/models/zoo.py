"""Model zoo: the entry points the serve engine and the trainer call, by
the reference's names, and the batch helpers the tests and the chip smoke
run build their inputs with."""

from __future__ import annotations

import numpy as np
import torch

from . import transformer
from .bridge import params_from_numpy

__all__ = ["init", "step_packed", "step_spec", "decode_step", "prefill_chunk", "prefill",
           "supports_chunked_prefill", "supports_paged_kv", "init_cache",
           "dense_packed_plans", "chunk_plan", "dense_step_plans",
           "merge_slot", "init_paged_cache", "map_paged_caches",
           "copy_paged_blocks", "params_from_numpy", "forward", "loss_fn",
           "token_seq_len", "make_batch", "init_axes", "abstract_params"]

init = transformer.init
init_axes = transformer.init_axes
step_packed = transformer.step_packed
step_spec = transformer.step_spec
decode_step = transformer.decode_step
prefill_chunk = transformer.prefill_chunk
prefill = transformer.prefill
supports_chunked_prefill = transformer.supports_chunked_prefill
supports_paged_kv = transformer.supports_paged_kv
init_cache = transformer.init_cache
dense_packed_plans = transformer.dense_packed_plans
chunk_plan = transformer.chunk_plan
dense_step_plans = transformer.dense_step_plans
merge_slot = transformer.merge_slot
init_paged_cache = transformer.init_paged_cache
map_paged_caches = transformer.map_paged_caches
copy_paged_blocks = transformer.copy_paged_blocks
forward = transformer.forward
loss_fn = transformer.loss_fn


def token_seq_len(cfg, seq_len: int) -> int:
    """The backbone's sequence is ``seq_len``; the vision prefix's patches
    take ``num_patches`` of it."""
    if cfg.frontend == "vision":
        return seq_len - cfg.num_patches
    return seq_len


def make_batch(cfg, shape, rng: np.random.Generator, device) -> dict:
    """A concrete batch for ``shape`` (a ``ShapeConfig``) on ``device``,
    drawn from ``rng`` in the reference's order (tokens, labels, then the
    frontend's ``patches`` or ``frames`` from ``standard_normal``), so a
    generator seeded alike gives the JAX package's batch: int32 tokens and
    labels, f32 patches and frames."""
    b, s = shape.global_batch, shape.seq_len
    st = token_seq_len(cfg, s)
    batch = {}
    if shape.kind in ("train", "prefill"):
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, st))
        if shape.kind == "train":
            batch["labels"] = rng.integers(0, cfg.vocab_size, (b, st))
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.frontend_dim))
    if cfg.encoder_decoder:
        batch["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model))
    return {k: torch.from_numpy(v.astype(np.int32 if k in ("tokens", "labels")
                                         else np.float32)).to(device)
            for k, v in batch.items()}


def abstract_params(cfg):
    """``(shapes, axes)``: the params tree as meta tensors (each leaf's
    shape and dtype, nothing allocated, no random draw) and its axes tree
    (:func:`init_axes`), which mirrors it leaf for leaf."""
    return transformer.init(cfg, None, "meta"), transformer.init_axes(cfg)
