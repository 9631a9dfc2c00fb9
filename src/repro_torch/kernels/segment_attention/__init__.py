from .ops import paged_segment_attention_op, segment_attention_op
from .ref import paged_segment_attention_ref, segment_attention_ref
from .segment_attention import paged_segment_attention, segment_attention

__all__ = [
    "segment_attention",
    "segment_attention_ref",
    "segment_attention_op",
    "paged_segment_attention",
    "paged_segment_attention_ref",
    "paged_segment_attention_op",
]
