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

The wrapper checks device, dtype, shape, strides and alignment, plans the
launch from the shapes alone (:func:`launch_plan`: keys a ring stage,
split CTAs an SM, head chunks, the key split), allocates the f32 partials
as one scratch tensor (two regions of one allocation), launches on the
current stream, raises if a launch failed, and counts launches in
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
KEY_TILES = (64, 32, 16)    # keys a ring stage holds: the largest that fits
KEY_TILE = KEY_TILES[0]
STAGES = 3                  # stages of the cp.async ring (csrc kStages)
WARPS = 8                   # warps of a split CTA (csrc kWarps)
HEAD_CHUNK = 16             # query heads a split CTA holds, at most
MAX_SPLIT = 512             # key slots a split holds, at most
MAX_SMEM = 232_448          # dynamic shared memory a CTA may use (H100)
TWO_PER_SM = 113 * 1024     # dynamic shared memory of each of two CTAs an SM
CTAS_PER_SM = 2             # the split aims at about this many CTAs per SM


def padded_cache_len(n: int, block_kv: int = DEFAULT_BLOCK_KV) -> int:
    """The reference's engine sizing: lengths above one ``block_kv`` tile
    round up to a tile multiple (its TPU kernel never pads such a cache)."""
    if n <= block_kv:
        return n
    return -(-n // block_kv) * block_kv


def row_bytes(esz: int, d: int) -> int:
    """Bytes of a K/V row in shared memory: the power of two, at least 16,
    that holds it (csrc ``row_bytes``)."""
    r = 16
    while r < d * esz:
        r *= 2
    return r


def key_parts(g: int) -> int:
    """Parts a tile's keys are cut into, one warp of a head each: two for
    ``g >= 4`` query heads a KV head (a warp's heads repeat every four),
    else ``WARPS // g``."""
    return 2 if g >= 4 else WARPS // g


def warp_heads(g: int) -> int:
    """Query heads a warp holds at most (csrc ``warp_heads``, the kernel's
    NH): a chunk's heads four warps apart, as 1, 2 or 4."""
    return 1 if g <= 4 else 2 if g <= 8 else 4


def smem_bytes(esz: int, d: int, g: int, tile: int, split: int) -> int:
    """Dynamic shared memory of one split CTA (csrc ``smem_bytes``): the K/V
    ring (which afterwards holds the key parts' partials for their merge),
    q as f32, the warps' probabilities, the split's live list and its
    ballot masks, and the live count."""
    heads = min(g, HEAD_CHUNK)
    ring = max(STAGES * 2 * tile * row_bytes(esz, d),
               4 * key_parts(g) * heads * (d + 4))
    return (ring + 4 * heads * d
            + 4 * WARPS * (tile // key_parts(g)) * warp_heads(g)
            + 4 * split + 4 * -(-split // 32) + 16)


def tile_keys(esz: int, d: int, g: int) -> int:
    """Keys a ring stage holds: the largest of ``KEY_TILES`` whose CTA fits
    ``MAX_SMEM`` with a split of ``MAX_SPLIT`` slots."""
    for tile in KEY_TILES:
        if smem_bytes(esz, d, g, tile, MAX_SPLIT) <= MAX_SMEM:
            return tile
    raise ValueError(f"a group of {g} heads of {d} needs "
                     f"{smem_bytes(esz, d, g, KEY_TILES[-1], MAX_SPLIT)} "
                     f"bytes of shared memory")


def ctas_per_sm(esz: int, d: int, g: int) -> int:
    """Split CTAs that fit an SM together: two where each takes at most
    ``TWO_PER_SM`` bytes of shared memory, else one."""
    fits = smem_bytes(esz, d, g, tile_keys(esz, d, g), MAX_SPLIT)
    return CTAS_PER_SM if fits <= TWO_PER_SM else 1


def split_len(s: int, groups: int, sms: int, tile: int = KEY_TILE,
              per_sm: int = CTAS_PER_SM) -> int:
    """Key slots per split: as many splits of the ``s`` slots as fill one
    wave of ``per_sm`` CTAs on each of ``sms`` SMs across the ``groups``
    CTAs of a split (rows x KV heads x head chunks), at least enough that
    none holds more than ``MAX_SPLIT``; each split a whole number of
    ``tile``-key tiles.  A function of the shapes alone (no host sync)."""
    want = max(1, per_sm * sms // max(1, groups), -(-s // MAX_SPLIT))
    per = -(-s // want)
    return max(tile, -(-per // tile) * tile)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, h: int, kv: int, s: int, d: int, esz: int,
                sms: int) -> dict:
    """How the wrapper launches one call: keys a tile, split CTAs an SM,
    head chunks, key slots a split, splits and split CTAs (cached: a
    decode loop repeats its shapes; do not modify the dict)."""
    g = h // kv
    tile, per_sm = tile_keys(esz, d, g), ctas_per_sm(esz, d, g)
    chunks = -(-g // HEAD_CHUNK)
    n = split_len(s, b * kv * chunks, sms, tile, per_sm)
    n_split = -(-s // n)
    return dict(tile=tile, per_sm=per_sm, head_chunks=chunks, split=n,
                n_split=n_split, ctas=n_split * b * kv * chunks,
                stages=STAGES, smem=smem_bytes(esz, d, g, tile, n))


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _launcher():
    fn = _build.library("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
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
    # raises where no tile fits, before anything is allocated
    plan = launch_plan(b, h, kv, s, d, q.element_size(),
                       sm_count(dev.index))
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out.zero_()
    n, n_split, g = plan["split"], plan["n_split"], h // kv
    # one f32 scratch for both partials: o [B, Kv, n_split, G, D], then
    # (m, l) [B, Kv, n_split, G, 2]
    parts = b * kv * n_split * g
    scratch = torch.empty(parts * (d + 2), dtype=torch.float32, device=dev)
    o_part = scratch.data_ptr()
    ml_part = o_part + 4 * parts * d
    sb, sh, ss, _ = k.stride()
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
        q_pos.data_ptr(), o_part, ml_part, out.data_ptr(), b, h, kv, s, d, n,
        n_split, plan["tile"], sb, sh, ss,
        int(window), float(d) ** -0.5, KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention: CUDA error {err} at launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
