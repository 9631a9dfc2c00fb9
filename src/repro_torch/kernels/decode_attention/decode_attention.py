"""Dense decode attention on Hopper: the wrapper of
``csrc/decode_attention.cu`` (one query token per row against a dense,
positioned KV cache, the keys split across CTAs and the splits combined),
and the cache sizing helper.

Layout:

  * ``q [B, H, D]`` contiguous;
  * ``k, v [B, Kv, S, D]`` with D contiguous and any B, Kv and S strides
    (the same for both): the model passes its ``[B, S, Kv, D]`` dense ring
    as a transposed view, which the kernel reads in place;
  * ``k_pos [B, S] int32``: each slot's absolute position, -1 = unwritten;
    ``q_pos [B] int32``;
  * a key is admitted when ``k_pos >= 0``, ``k_pos <= q_pos`` and, with a
    window, ``q_pos - k_pos < window``; a row no key admits gives zeros.

The wrapper checks device, dtype, shape, strides and alignment, picks the
key split, allocates the f32 partials, launches on the current stream,
raises if a launch failed, and counts launches in
``decode_attention.launches``.  The plain version of the same function is
:func:`~repro_torch.kernels.decode_attention.ref.decode_attention_plain`.

The serve engine sizes ``cache_len`` (and with it ``blocks_per_seq``) with
:func:`padded_cache_len`, so the port's engine allocates exactly what the
reference engine allocates for the same options; the kernel itself takes
any S."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (HEAD_DIMS, KERNEL_DTYPES, _build,
                                 check_operand)

DEFAULT_BLOCK_KV = 512
KEY_TILE = 32               # keys per shared-memory tile (csrc kTile)
MAX_SMEM = 232_448          # dynamic shared memory a CTA may use (H100)
CTAS_PER_SM = 2             # the split aims at about this many CTAs per SM


def padded_cache_len(n: int, block_kv: int = DEFAULT_BLOCK_KV) -> int:
    """The reference's engine sizing: lengths above one ``block_kv`` tile
    round up to a tile multiple (its TPU kernel never pads such a cache)."""
    if n <= block_kv:
        return n
    return -(-n // block_kv) * block_kv


def split_len(s: int, groups: int, sms: int) -> int:
    """Keys per split: enough splits of the ``s`` keys for the ``groups``
    (row, KV head) pairs to give about ``CTAS_PER_SM`` CTAs per SM, each
    split a whole number of key tiles."""
    want = -(-CTAS_PER_SM * sms // max(1, groups))
    per = -(-s // want)
    return max(KEY_TILE, -(-per // KEY_TILE) * KEY_TILE)


def smem_bytes(g: int, d: int) -> int:
    """Dynamic shared memory of one split CTA (csrc ``smem_bytes``)."""
    return 4 * (2 * g * d + KEY_TILE * (2 * d + 4) + g * KEY_TILE + 3 * g) \
        + 4 * KEY_TILE


@functools.cache
def _launcher():
    fn = _build.library("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q: [B, H, D]; k, v: [B, Kv, S, D] (strided, D contiguous); k_pos:
    [B, S] int32; q_pos: [B] int32 -> [B, H, D] in q's dtype.  CUDA tensors
    only."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"q: dtype {q.dtype} not in {list(KERNEL_DTYPES)}")
    check_operand("q", q, dtype=q.dtype, ndim=3, device=dev)
    check_operand("k", k, dtype=q.dtype, ndim=4, device=dev,
                  contiguous=False)
    check_operand("v", v, dtype=q.dtype, ndim=4, device=dev,
                  contiguous=False)
    check_operand("k_pos", k_pos, dtype=torch.int32, ndim=2, device=dev,
                  align=4)
    check_operand("q_pos", q_pos, dtype=torch.int32, ndim=1, device=dev,
                  align=4)
    b, h, d = q.shape
    _, kv, s, _ = k.shape
    if k.shape != (b, kv, s, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if v.stride() != k.stride():
        raise ValueError(f"k and v strides differ: {k.stride()} / "
                         f"{v.stride()}")
    if k_pos.shape != (b, s) or q_pos.shape != (b,):
        raise ValueError(f"k_pos {tuple(k_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match [B, S] = "
                         f"[{b}, {s}]")
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if smem_bytes(h // kv, d) > MAX_SMEM:
        raise ValueError(f"a group of {h // kv} heads of {d} needs "
                         f"{smem_bytes(h // kv, d)} bytes of shared memory")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = split_len(s, b * kv, sms)
    n_split = -(-s // n)
    g = h // kv
    o_part = torch.empty((b, kv, n_split, g, d), dtype=torch.float32,
                         device=dev)
    ml_part = torch.empty((b, kv, n_split, g, 2), dtype=torch.float32,
                          device=dev)
    sb, sh, ss, _ = k.stride()
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
        q_pos.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(),
        out.data_ptr(), b, h, kv, s, d, n, n_split, sb, sh, ss, int(window),
        float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention: CUDA error {err} at launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
