from .decode_attention import (DEFAULT_BLOCK_KV, decode_attention,
                               padded_cache_len)
from .ops import decode_attention_op
from .ref import decode_attention_plain, decode_attention_ref, decode_mask

__all__ = ["DEFAULT_BLOCK_KV", "decode_attention", "decode_attention_op",
           "decode_attention_plain", "decode_attention_ref", "decode_mask",
           "padded_cache_len"]
