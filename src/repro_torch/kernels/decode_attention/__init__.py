"""Dense decode attention: the plain oracle and the cache sizing helper.

The dense kernel itself is not on the serve path (paged KV is), so only
:func:`padded_cache_len` (engine sizing) and :func:`decode_attention_ref`
(the oracle the paged decode oracle defers to) are ported so far."""

from .decode_attention import DEFAULT_BLOCK_KV, padded_cache_len
from .ref import decode_attention_ref, decode_mask

__all__ = ["DEFAULT_BLOCK_KV", "decode_attention_ref", "decode_mask",
           "padded_cache_len"]
