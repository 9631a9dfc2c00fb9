"""Model zoo: the entry points the serve engine and the trainer call, by
the reference's names."""

from __future__ import annotations

from . import transformer
from .bridge import params_from_numpy

__all__ = ["init", "step_packed", "step_spec", "decode_step", "prefill_chunk", "prefill",
           "supports_chunked_prefill", "supports_paged_kv", "init_cache",
           "dense_packed_plans", "chunk_plan", "dense_step_plans",
           "merge_slot", "init_paged_cache", "map_paged_caches",
           "copy_paged_blocks", "params_from_numpy", "forward", "loss_fn"]

init = transformer.init
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
