from .ops import paged_decode_attention_op
from .paged_attention import paged_decode_attention, split_blocks
from .ref import paged_decode_attention_ref, paged_gather

__all__ = ["paged_decode_attention", "paged_decode_attention_op",
           "paged_decode_attention_ref", "paged_gather", "split_blocks"]
