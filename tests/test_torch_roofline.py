"""The port's roofline (``repro_torch.roofline``) and the kernels' ``meta``
branches.

* ``model_flops`` for every arch x shape and ``roofline_terms`` on the
  same inputs and the same ``hw`` dict equal the JAX package's;
  ``HW`` holds the H100 SXM's figures.
* :class:`~repro_torch.roofline.op_cost.OpCost` on hand-made cases, each
  count worked out by hand: one matrix product, a batched product, a
  gather, an index put, a reduction, live bytes on ``meta``, and the ops
  that need the data.
* The ``meta`` branch of every flash entry point and of dense decode:
  the outputs' shapes and dtypes equal a CPU run of the plain version's,
  nothing counts as a launch, and the charge equals the kernels' counts
  (``flash_bound``, ``dense_bound``).  Every other kernel entry point
  raises on ``meta``, the wrapper naming itself; ``use_plain`` still
  takes the CPU's plain version, and raises for any device but the CPU
  and CUDA.
"""

import types

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JX_SHAPES
from repro.configs import cells as jx_cells
from repro.configs import get_config as jx_get_config
from repro.roofline import analysis as jx_analysis
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.kernels import on_meta, use_plain
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_op,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_op, attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_dkv,
                                                 flash_attention_dq,
                                                 flash_attention_fwd_lse,
                                                 flash_attention_grad)
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_decode_attention_op)
from repro_torch.kernels.rglru import (rglru_op, rglru_scan,
                                       rglru_scan_state, rglru_state_op)
from repro_torch.kernels.rwkv6 import (rwkv6_op, rwkv6_scan,
                                       rwkv6_scan_state, rwkv6_state_op)
from repro_torch.kernels.segment_attention import (
    paged_segment_attention, paged_segment_attention_op, segment_attention,
    segment_attention_op)
from repro_torch.roofline import HW, model_flops, op_cost, roofline_terms
from repro_torch.roofline.op_cost import (DataDependentOp, OpCost, analyze,
                                          dense_bound, flash_bound)

META = torch.device("meta")
CPU = torch.device("cpu")


def test_hw_holds_the_h100_sxm_figures():
    assert HW["peak_flops"] == 989e12
    assert HW["peak_flops_f32"] == 67e12
    assert HW["hbm_bw"] == 3.35e12
    assert HW["ici_bw"] == 450e9
    assert set(jx_analysis.HW) <= set(HW)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_terms_equal_reference(arch):
    cfg, ref = get_config(arch), jx_get_config(arch)
    assert [s for s, _ in cells(arch)] == [s for s, _ in jx_cells(arch)]
    for name, shape in SHAPES.items():
        got = model_flops(cfg, shape)
        assert got == jx_analysis.model_flops(ref, JX_SHAPES[name])
        cost = {"flops": got / 256, "bytes accessed": got / 2e3}
        for hw in (HW, jx_analysis.HW):
            for coll in (0, 7.5e9, 3e12):
                assert roofline_terms(cost, coll, hw=hw) == \
                    jx_analysis.roofline_terms(cost, coll, hw=hw)


def test_roofline_terms_at_hw_by_hand():
    t = roofline_terms({"flops": 989e12, "bytes accessed": 6.7e12}, 450e9)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (1.0, 2.0,
                                                                   1.0)
    assert t["dominant"] == "memory_s" and t["bound_s"] == 2.0


# ---- OpCost on hand-made cases ------------------------------------------


def counted(fn, *args):
    return analyze(fn, *args)[0]


def test_one_matrix_product():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    got = counted(torch.mm, a, b)
    assert got["flops"] == 2 * 3 * 7 * 5
    assert got["bytes"] == (3 * 7 + 3 * 5 + 5 * 7) * 4
    # linear lowers to a product too (addmm with the bias)
    w, bias = torch.ones(7, 5), torch.ones(7)
    assert counted(torch.nn.functional.linear, a, w, bias)["flops"] == 210


def test_batched_product():
    a, b = torch.ones(2, 3, 5), torch.ones(2, 5, 7)
    for fn in (torch.bmm, torch.matmul,
               lambda x, y: torch.einsum("bij,bjk->bik", x, y)):
        got = counted(fn, a, b)
        assert got["flops"] == 2 * 2 * 3 * 7 * 5
        assert got["bytes"] == (2 * 3 * 7 + 2 * 3 * 5 + 2 * 5 * 7) * 4


def test_gather_counts_twice_its_result():
    x, idx = torch.ones(10, 4), torch.tensor([1, 3, 5])
    assert counted(torch.index_select, x, 0, idx)["bytes"] == 2 * 3 * 4 * 4
    assert counted(lambda t, i: t[i], x, idx)["bytes"] == 2 * 3 * 4 * 4
    got = counted(torch.nn.functional.embedding, idx, x)
    assert got["bytes"] == 2 * 3 * 4 * 4 and got["flops"] == 0


def test_index_put_counts_twice_its_update():
    x, idx, v = torch.zeros(10, 4), torch.tensor([1, 3, 5]), torch.ones(3, 4)

    def put(t, i, u):
        t[i] = u
    got = counted(put, x, idx, v)
    assert got["bytes"] == 2 * 3 * 4 * 4


def test_reduction_reads_its_operand_and_writes_its_result():
    x = torch.ones(10, 4)
    assert counted(lambda t: t.sum(dim=1), x)["bytes"] == (40 + 10) * 4
    assert counted(lambda t: t.sum(dim=1), x)["bytes_raw"] == (40 + 10) * 4


def test_elementwise_and_views_move_no_hbm_bytes():
    x = torch.ones(10, 4)
    got = counted(lambda t: (t * 2).t().unsqueeze(0), x)
    assert got["bytes"] == 0 and got["flops"] == 0
    assert got["bytes_raw"] == 2 * 40 * 4          # the multiply only


def test_live_bytes_on_meta():
    arg = torch.empty(1000, device=META)           # 4000 -> 4096
    counter = OpCost([arg])
    assert counter.argument_bytes == 4096
    with counter:
        a = torch.empty(1024, device=META)         # 4096
        b = torch.empty(256, device=META)          # 1024
        v = a.view(32, 32)                          # a view: nothing new
        del a, v
        c = torch.empty(2048, device=META)          # 8192
        del b, c
    assert counter.peak_live_bytes == 4096 + 1024 + 8192
    assert counter.live_bytes == 4096
    assert counter.result()["peak_live_bytes"] == 13312
    assert counter.result()["argument_bytes"] == 4096


def test_attribute_ranks_by_bytes():
    a, b = torch.ones(8, 8), torch.ones(8, 8)
    _, counter = analyze(lambda x, y: (x @ y).sum(), a, b)
    ranked = counter.attribute(top=5)
    assert [r["op"] for r in ranked[:2]] == ["mm", "sum"]
    assert ranked[0]["tag"] == "dot" and ranked[0]["calls"] == 1
    assert ranked[0]["flops"] == 2 * 8 * 8 * 8


@pytest.mark.parametrize("fn,op", [
    (lambda t: t.nonzero(), "aten.nonzero"),
    (lambda t: t.sum().item(), "aten._local_scalar_dense"),
    (lambda t: int(t[0]), "aten._local_scalar_dense"),
    (lambda t: t.cpu(), "aten._to_copy to cpu"),
])
def test_data_dependent_ops_raise_on_meta(fn, op):
    with pytest.raises(DataDependentOp) as e:
        analyze(fn, torch.empty(4, device=META))
    assert e.value.op.startswith(op)
    assert op in str(e.value)


def test_no_collectives_in_one_process():
    got = counted(torch.mm, torch.ones(2, 2), torch.ones(2, 2))
    assert got["collective_bytes"] == got["coll_count"] == 0
    assert set(op_cost.COLLECTIVES) <= set(got)


# ---- the kernels on meta ---------------------------------------------------

FLASH_CASES = [
    # (b, h, kv, s, d, causal, window, dtype, sk)
    (2, 4, 2, 64, 16, True, 0, torch.float32, None),
    (1, 8, 1, 130, 128, True, 32, torch.bfloat16, None),
    (2, 6, 6, 77, 64, False, 0, torch.bfloat16, 150),
    (1, 2, 2, 40, 256, False, 0, torch.float32, None),
]


def qkv(case, device, seed=0):
    b, h, kv, s, d, causal, window, dtype, sk = case
    sk = s if sk is None else sk
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=gen)
    k = torch.randn(b, kv, sk, d, generator=gen)
    v = torch.randn(b, kv, sk, d, generator=gen)
    do = torch.randn(b, h, s, d, generator=gen)
    return [t.to(device, dtype) for t in (q, k, v, do)]


def charged(fn):
    """fn's outputs and the kernels' charges under an OpCost."""
    counter = OpCost()
    with counter:
        out = fn()
    return out, {r["op"]: (r["flops"], r["bytes"], r["calls"])
                 for r in counter.ops.values() if r["tag"] == "kernel"}


def like(got, want):
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == META
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


def bound(kernel, case):
    b, h, kv, s, d, causal, window, dtype, sk = case
    c = flash_bound(kernel, b, h, kv, s, d, causal, window, dtype, sk)
    return (c.flops, c.nbytes)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_forward_on_meta(case):
    causal, window = case[5], case[6]
    mask = dict(causal=causal, window=window)
    q, k, v, _ = qkv(case, CPU)
    mq, mk, mv, _ = qkv(case, META)
    launches = flash_attention.launches, flash_attention_fwd_lse.launches
    out, ch = charged(lambda: flash_attention(mq, mk, mv, **mask))
    like(out, attention_ref(q, k, v, **mask))
    assert ch == {"flash_attention": bound("flash_attention", case) + (1,)}
    out, ch = charged(lambda: flash_attention_fwd_lse(mq, mk, mv, **mask))
    like(out, attention_lse_ref(q, k, v, **mask))
    assert ch == {"flash_attention_fwd_lse":
                  bound("flash_attention_fwd_lse", case) + (1,)}
    # the model-layout dispatcher reaches the same branch
    out, ch = charged(lambda: attention_op(*(t.transpose(1, 2) for t in
                                             (mq, mk, mv)), **mask))
    like(out, attention_ref(q, k, v, **mask).transpose(1, 2))
    assert set(ch) == {"flash_attention"}
    assert (flash_attention.launches,
            flash_attention_fwd_lse.launches) == launches


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_on_meta(case):
    causal, window = case[5], case[6]
    mask = dict(causal=causal, window=window)
    q, k, v, do = qkv(case, CPU)
    o, lse = attention_lse_ref(q, k, v, **mask)
    want = attention_bwd_ref(q, k, v, o, lse, do, **mask)
    mq, mk, mv, mdo = qkv(case, META)
    mo, mlse = o.to(META), lse.to(META)
    launches = flash_attention_dq.launches, flash_attention_dkv.launches
    out, ch = charged(lambda: flash_attention_bwd(mq, mk, mv, mo, mlse, mdo,
                                                  **mask))
    like(out, want)
    assert ch == {"flash_attention_dq": bound("flash_attention_dq", case)
                  + (1,),
                  "flash_attention_dkv": bound("flash_attention_dkv", case)
                  + (1,)}
    dsum = torch.empty(mlse.shape, device=META)
    like(flash_attention_dq(mq, mk, mv, mdo, mlse, dsum, **mask), want[0])
    like(flash_attention_dkv(mq, mk, mv, mdo, mlse, dsum, **mask), want[1:])
    assert (flash_attention_dq.launches,
            flash_attention_dkv.launches) == launches


def test_flash_autograd_on_meta():
    case = FLASH_CASES[0]
    mq, mk, mv, _ = (t.requires_grad_() for t in qkv(case, META))

    def step():
        flash_attention_grad(mq, mk, mv, True, 0).float().sum().backward()
    _, ch = charged(step)
    assert set(ch) == {"flash_attention_fwd_lse", "flash_attention_dq",
                       "flash_attention_dkv"}
    for t in (mq, mk, mv):
        assert t.grad.shape == t.shape and t.grad.device == META


def dense_inputs(device, b=3, h=8, kv=2, s=100, d=128, dtype=torch.float32):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(b, h, d, generator=gen).to(dtype)
    k = torch.randn(b, kv, s, d, generator=gen).to(dtype)
    v = torch.randn(b, kv, s, d, generator=gen).to(dtype)
    # every key written and behind the query: all admitted
    k_pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    q_pos = torch.full((b,), s - 1, dtype=torch.int32)
    return {n: t.to(device) for n, t in dict(q=q, k=k, v=v, k_pos=k_pos,
                                              q_pos=q_pos).items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 40])
def test_dense_decode_on_meta(dtype, window):
    x, mx = dense_inputs(CPU, dtype=dtype), dense_inputs(META, dtype=dtype)
    launches = decode_attention.launches
    out, ch = charged(lambda: decode_attention(**mx, window=window))
    like(out, decode_attention_plain(**x, window=window))
    c = dense_bound(x, window)
    assert ch == {"decode_attention": (c.flops, c.nbytes, 1)}
    out, ch = charged(lambda: decode_attention_op(**mx, window=window))
    like(out, decode_attention_plain(**x, window=window))
    assert decode_attention.launches == launches


def test_kernel_bound_by_hand():
    c = flash_bound("flash_attention", 1, 1, 1, 4, 16, True, 0,
                    torch.float32)
    assert (c.flops, c.nbytes) == (2 * 2 * 16 * 10, 4 * 4 * 16 * 4)
    assert c.by == "bytes" and c.ms == 1024 / 3.35e12 * 1e3


def meta_args(*shapes_dtypes):
    return [torch.empty(s, dtype=dt, device=META) for s, dt in shapes_dtypes]


F32, I32 = torch.float32, torch.int32
OTHER_KERNELS = {
    "paged_segment_attention": (
        [paged_segment_attention, paged_segment_attention_op],
        [((8, 2, 16), F32), ((4, 1, 16, 16), F32), ((4, 1, 16, 16), F32),
         ((2, 2), I32), ((8,), I32), ((8,), I32)]),
    "segment_attention": (
        [segment_attention, segment_attention_op],
        [((8, 2, 16), F32), ((8, 1, 16), F32), ((8, 1, 16), F32),
         ((8,), I32), ((8,), I32), ((8,), I32), ((8,), I32)]),
    "paged_decode_attention": (
        [paged_decode_attention, paged_decode_attention_op],
        [((2, 2, 16), F32), ((4, 1, 16, 16), F32), ((4, 1, 16, 16), F32),
         ((2, 2), I32), ((2,), I32)]),
    "rglru_scan_state": (
        [rglru_scan_state, rglru_state_op],
        [((1, 8, 4), F32), ((1, 8, 4), F32), ((1, 4), F32)]),
    "rglru_scan": ([rglru_scan, rglru_op],
                   [((1, 8, 4), F32), ((1, 8, 4), F32)]),
    "rwkv6_scan_state": (
        [rwkv6_scan_state, rwkv6_state_op],
        [((1, 8, 64), F32)] * 4 + [((1, 64), F32), ((1, 64, 64), F32)]),
    "rwkv6_scan": ([rwkv6_scan, rwkv6_op],
                   [((1, 8, 64), F32)] * 4 + [((1, 64), F32)]),
}


@pytest.mark.parametrize("name", list(OTHER_KERNELS))
def test_other_kernels_raise_on_meta(name):
    """The wrapper names itself; its dispatch refuses the device."""
    (wrapper, op), shapes = OTHER_KERNELS[name]
    own = name.replace("rglru_scan", "rglru_scan_state").replace(
        "rwkv6_scan", "rwkv6_scan_state").replace("_state_state", "_state")
    with pytest.raises(ValueError, match=f"{own}.*meta"):
        wrapper(*meta_args(*shapes))
    with pytest.raises(ValueError, match="no kernel or plain version for "
                       "device meta"):
        op(*meta_args(*shapes))


def test_use_plain_devices():
    cpu, meta = torch.empty(1), torch.empty(1, device=META)
    assert use_plain(cpu, cpu) is True
    assert on_meta(meta, meta) and not on_meta(meta, cpu)
    with pytest.raises(ValueError, match="several devices"):
        use_plain(cpu, meta)
    for dev in (META, torch.device("mps")):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            use_plain(types.SimpleNamespace(device=dev))


def test_meta_outputs_allocate_what_the_kernel_does():
    """The flash forward on meta allocates its output and LSE only, never
    the plain version's [B, H, S, S] scores."""
    case = (1, 32, 4, 4096, 128, True, 0, torch.bfloat16, None)
    mq, mk, mv, _ = qkv(case, META)
    counter = OpCost([mq, mk, mv])
    with counter:
        o, lse = flash_attention_fwd_lse(mq, mk, mv)
    assert counter.peak_live_bytes - counter.argument_bytes == \
        o.numel() * 2 + lse.numel() * 4
    assert np.isclose(counter.counts["flops"],
                      bound("flash_attention_fwd_lse", case)[0])
