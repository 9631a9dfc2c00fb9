from .ops import paged_segment_attention_op, segment_attention_op
from .ref import paged_segment_attention_ref, segment_attention_ref
from .segment_attention import (library_paged_segment_route,
                                library_segment_route,
                                paged_segment_attention, paged_segment_route,
                                segment_attention, segment_grid,
                                segment_route, tile_items)

__all__ = [
    "segment_attention",
    "segment_attention_ref",
    "segment_attention_op",
    "paged_segment_attention",
    "paged_segment_attention_ref",
    "paged_segment_attention_op",
    "segment_route",
    "paged_segment_route",
    "library_segment_route",
    "library_paged_segment_route",
    "segment_grid",
    "tile_items",
]
