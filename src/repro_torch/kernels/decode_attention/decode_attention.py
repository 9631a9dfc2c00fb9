"""Cache sizing for the dense decode-attention kernel's KV tiling.

The serve engine sizes ``cache_len`` (and with it ``blocks_per_seq``) with
:func:`padded_cache_len`, so the port's engine allocates exactly what the
reference engine allocates for the same options."""

from __future__ import annotations

DEFAULT_BLOCK_KV = 512


def padded_cache_len(n: int, block_kv: int = DEFAULT_BLOCK_KV) -> int:
    """Smallest cache length >= n that the dense decode kernel never pads:
    lengths above one ``block_kv`` tile round up to a tile multiple."""
    if n <= block_kv:
        return n
    return -(-n // block_kv) * block_kv
