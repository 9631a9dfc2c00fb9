"""The port's flash attention family against the JAX package: the plain
forward (with and without the logsumexp) and backward, the autograd
Function over them, the model-layout op and ``layers.attention``.

Plain versions (what a CPU tensor runs) are held against the JAX oracle
``attention_ref``, ``jax.grad`` of it, and the Pallas kernels
``flash_attention``, ``flash_attention_fwd_lse`` and
``flash_attention_bwd`` in interpret mode, on the same inputs made from a
numpy seed: MHA, GQA and MQA; causal, windowed and non-causal (with and
without a window); S = 1, 63 and 130 (not multiples of any tile); D = 16
and 64; f32 and bf16.

Tolerances: f32 as the reference's own kernel tests hold its kernels
(forward ``2e-5``, gradients ``atol=5e-6, rtol=5e-5``, logsumexp
``1e-4``).  bf16 ``atol=rtol=2e-2``: every side computes in f32 from the
same bf16 inputs and rounds its outputs to bf16 once, except that the
Pallas backward rounds each query head's dK/dV to bf16 before summing the
GQA group, so the two differ by up to an ulp of bf16 (2^-8) per head.

The forward's and the backward's route rule (bf16 at D 64, 120 and 128 on
the tensor cores, everything else on the CUDA cores) is pinned here on the
CPU, and so are the forward wrappers' per-route counters.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
the card, at D = 120, 128 and 256 too, the tensor-core forward and
backward also at their tile edges (S = 1, 63, 64, 65, 127, 130 and 4096;
windows 32 and 1024, causal and not; groups of 1, 4 and 8) with the route
each call took read from the wrappers' per-route counters; they skip
where there is no card.  The
machine with the card has no JAX, so this file imports the JAX package
only inside the ``jx`` fixture, and runs there without the repository's
conftest:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_flash_attention.py
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import HEAD_DIMS
from repro_torch.kernels.flash_attention import (
    TENSOR_CORE_HEAD_DIMS, FlashAttention, attention_bwd_ref,
    attention_lse_ref, attention_op, attention_ref, bwd_route,
    flash_attention, flash_attention_bwd, flash_attention_dkv,
    flash_attention_dq, flash_attention_fwd_lse, fwd_route,
    library_bwd_route, library_fwd_route)
from repro_torch.models import layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": dict(atol=5e-6, rtol=5e-5),
            "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (S, D, H, Kv, causal, window): MHA/GQA/MQA, causal/windowed/non-causal,
# S = 1, 63, 130, D = 16, 64
CASES = [
    (63, 16, 4, 4, True, 0),
    (130, 16, 4, 2, True, 0),
    (130, 64, 4, 1, True, 40),
    (63, 64, 4, 2, False, 0),
    (130, 16, 4, 4, False, 20),
    (1, 16, 4, 1, True, 0),
    (1, 64, 4, 2, False, 0),
    (63, 64, 4, 4, True, 9),
]


def _case_id(c):
    s, d, h, kv, causal, window = c
    kind = "causal" if causal else "noncausal"
    return f"S{s}-D{d}-H{h}kv{kv}-{kind}-w{window}"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def jx():
    """The JAX package's oracle and Pallas kernels, and a converter from
    numpy arrays to JAX arrays of a dtype."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import flash_attention as fa
    dts = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

    def arr(a, dtype):
        return jnp.asarray(a, dts[dtype])

    return types.SimpleNamespace(jax=jax, jnp=jnp, arr=arr, ref=fa.attention_ref,
                                 fwd=fa.flash_attention,
                                 fwd_lse=fa.flash_attention_fwd_lse,
                                 bwd=fa.flash_attention_bwd)


def make_case(s, d, h, kv, seed=0, b=2, scale=1.0):
    """numpy f32 q [B,H,S,D], k, v [B,Kv,S,D], do [B,H,S,D]."""
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((b, h, s, d), np.float32) * scale,
                k=rng.standard_normal((b, kv, s, d), np.float32) * scale,
                v=rng.standard_normal((b, kv, s, d), np.float32) * scale,
                do=rng.standard_normal((b, h, s, d), np.float32))


def to_torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=TORCH_DT[dtype])


def f32(x):
    """JAX array or torch tensor -> numpy f32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# plain versions vs the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_forward_matches_jax(jx, case, dtype):
    s, d, h, kv, causal, window = case
    c = make_case(s, d, h, kv)
    q, k, v = (to_torch(c[n], dtype) for n in "qkv")
    o, lse = attention_lse_ref(q, k, v, causal=causal, window=window)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == q.shape[:3]
    torch.testing.assert_close(attention_ref(q, k, v, causal=causal,
                                             window=window), o)
    jq, jk, jv = (jx.arr(c[n], dtype) for n in "qkv")
    tol = TOL[dtype]
    want = jx.ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(f32(o), f32(want), atol=tol, rtol=tol)
    pl_o = jx.fwd(jq, jk, jv, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(f32(o), f32(pl_o), atol=tol, rtol=tol)
    pl_o, pl_lse = jx.fwd_lse(jq, jk, jv, causal=causal, window=window,
                              interpret=True)
    np.testing.assert_allclose(f32(o), f32(pl_o), atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), f32(pl_lse), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_backward_matches_jax(jx, case, dtype):
    s, d, h, kv, causal, window = case
    c = make_case(s, d, h, kv, seed=1, scale=0.5)
    q, k, v, do = (to_torch(c[n], dtype) for n in ("q", "k", "v", "do"))
    o, lse = attention_lse_ref(q, k, v, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                            window=window)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert all(g.dtype == q.dtype for g in got)
    jax, jnp = jx.jax, jx.jnp
    jq, jk, jv, jdo = (jx.arr(c[n], dtype) for n in ("q", "k", "v", "do"))
    want = jax.grad(lambda *a: jnp.sum(
        (jx.ref(*a, causal=causal, window=window) * jdo).astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)
    pl = jx.bwd(jq, jk, jv, jx.arr(f32(o), dtype), jnp.asarray(lse.numpy()),
                jdo, causal=causal, window=window, interpret=True)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, pl):
        np.testing.assert_allclose(f32(g), f32(w), **GRAD_TOL[dtype],
                                   err_msg=f"{name} vs jax.grad")
        np.testing.assert_allclose(f32(g), f32(p), **GRAD_TOL[dtype],
                                   err_msg=f"{name} vs Pallas")


# ---------------------------------------------------------------------------
# the autograd Function, the op and the model layer (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_function_matches_autograd_through_ref(case):
    """The Function's backward (the plain FA2 backward on CPU tensors)
    against ``torch.autograd`` through the plain forward."""
    s, d, h, kv, causal, window = case
    c = make_case(s, d, h, kv, seed=2, scale=0.5)
    ins = [to_torch(c[n], "float32").requires_grad_() for n in "qkv"]
    do = to_torch(c["do"], "float32")
    out = FlashAttention.apply(*ins, causal, window)
    got = torch.autograd.grad(out, ins, do)
    ref_ins = [t.detach().clone().requires_grad_() for t in ins]
    ref_out = attention_ref(*ref_ins, causal=causal, window=window)
    want = torch.autograd.grad(ref_out, ref_ins, do)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=2e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=5e-6, rtol=5e-5)


def test_function_takes_a_transposed_output_gradient():
    """Autograd may hand the backward a non-contiguous dO: the model layer
    transposes the output back to [B,S,H,D]."""
    c = make_case(37, 16, 4, 2, seed=3)
    ins = [to_torch(c[n], "float32").requires_grad_() for n in "qkv"]
    out = FlashAttention.apply(*ins, True, 0).transpose(1, 2)
    w = to_torch(c["do"], "float32").transpose(1, 2).contiguous()
    got = torch.autograd.grad((out * w).sum(), ins)
    ref_ins = [t.detach().clone().requires_grad_() for t in ins]
    ref = attention_ref(*ref_ins).transpose(1, 2)
    want = torch.autograd.grad((ref * w).sum(), ref_ins)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=5e-6, rtol=5e-5)


def test_attention_op_is_the_model_layout():
    c = make_case(50, 16, 4, 2, seed=4)
    q, k, v = (to_torch(c[n], "float32") for n in "qkv")
    got = attention_op(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=True, window=7)
    want = attention_ref(q, k, v, causal=True, window=7).transpose(1, 2)
    torch.testing.assert_close(got, want)


def test_layers_attention_takes_the_function_only_for_gradients():
    c = make_case(40, 16, 4, 2, seed=5)
    q, k, v = (to_torch(c[n], "float32").transpose(1, 2).requires_grad_()
               for n in "qkv")
    pos = torch.arange(40, dtype=torch.int32)
    out = layers.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                           window=9)
    # the output is the Function's, transposed back to [B,S,H,D]
    assert type(out.grad_fn.next_functions[0][0]).__name__ \
        == "FlashAttentionBackward"
    with torch.no_grad():
        plain = layers.attention(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                                 window=9)
    torch.testing.assert_close(out.detach(), plain)
    torch.testing.assert_close(plain, attention_op(q.detach(), k.detach(),
                                                   v.detach(), causal=True,
                                                   window=9))


def test_layers_attention_refuses_cross_attention():
    """Keys of another length than the queries (cross-attention) are
    taken without a mask only: the default causal call refuses them."""
    q = torch.zeros(1, 5, 4, 16)
    k = torch.zeros(1, 7, 2, 16)
    with pytest.raises(ValueError, match="only without a mask"):
        layers.attention(q, k, k, q_pos=torch.arange(5),
                         k_pos=torch.arange(7))


@pytest.mark.parametrize("wrapper", ["fwd", "fwd_lse", "bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A wrapper takes the plain version for no tensor: CPU tensors raise
    (the ops and the Function dispatch to the plain version first)."""
    c = make_case(8, 16, 4, 2)
    q, k, v, do = (to_torch(c[n], "float32") for n in ("q", "k", "v", "do"))
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "fwd":
            flash_attention(q, k, v)
        elif wrapper == "fwd_lse":
            flash_attention_fwd_lse(q, k, v)
        else:
            flash_attention_bwd(q, k, v, q, torch.zeros(2, 4, 8), do)


# the backward's route by (dtype, head dim), written out
ROUTES = {("float32", 16): "cuda_core", ("float32", 64): "cuda_core",
          ("float32", 120): "cuda_core", ("float32", 128): "cuda_core",
          ("float32", 256): "cuda_core", ("bfloat16", 16): "cuda_core",
          ("bfloat16", 64): "tensor_core", ("bfloat16", 120): "tensor_core",
          ("bfloat16", 128): "tensor_core", ("bfloat16", 256): "cuda_core"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_backward_route_rule(d, dtype):
    """bf16 at D 64, 120 and 128 takes the tensor-core kernels; f32 at
    every head dim and bf16 at D 16 and 256 the CUDA-core ones.  The
    wrappers count launches by this function, and the CUDA library's own
    dispatch is held to it on the card."""
    assert bwd_route(TORCH_DT[dtype], d) == ROUTES[dtype, d]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_route_rule(d, dtype):
    """The forward takes the same rule: bf16 at D 64, 120 and 128 on the
    tensor-core kernel, f32 at every head dim and bf16 at D 16 and 256 on
    the CUDA-core one."""
    assert fwd_route(TORCH_DT[dtype], d) == ROUTES[dtype, d]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_route_counters_ignore_cpu_calls(dtype):
    """Both forward wrappers count launches by route, from zero for both
    routes; a CPU call runs the plain version and counts nothing."""
    fwds = (flash_attention, flash_attention_fwd_lse)
    for f in fwds:
        assert f.route_launches == {"tensor_core": 0, "cuda_core": 0}
    c = make_case(63, 64, 4, 2)
    q, k, v = (to_torch(c[n], dtype).transpose(1, 2) for n in "qkv")
    attention_op(q, k, v)
    FlashAttention.apply(*(to_torch(c[n], dtype) for n in "qkv"), True, 0)
    for f in fwds:
        assert f.launches == 0
        assert f.route_launches == {"tensor_core": 0, "cuda_core": 0}


# ---------------------------------------------------------------------------
# the CUDA kernels vs the plain versions (on the card)
# ---------------------------------------------------------------------------

# (S, H, Kv, causal, window) on the card, at every head dim
CARD_CASES = [
    (130, 4, 4, True, 0),
    (257, 8, 2, True, 0),
    (300, 8, 1, True, 40),
    (1, 4, 2, True, 0),
    (97, 4, 2, False, 0),
    (200, 8, 4, False, 33),
]
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _card_case(case, d, dtype, dev):
    s, h, kv, causal, window = case
    c = make_case(s, d, h, kv, seed=6, scale=0.7)
    return ({n: to_torch(c[n], dtype, dev) for n in ("q", "k", "v", "do")},
            causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: f"S{c[0]}-H{c[1]}kv{c[2]}-"
                                       f"{'c' if c[3] else 'nc'}-w{c[4]}")
def test_forward_kernels_match_plain_on_card(cuda, case, d, dtype):
    x, causal, window = _card_case(case, d, dtype, cuda)
    q, k, v = x["q"], x["k"], x["v"]
    o, lse = flash_attention_fwd_lse(q, k, v, causal=causal, window=window)
    o2 = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want_o, want_lse = attention_lse_ref(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.to(o.dtype).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(o, o2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: f"S{c[0]}-H{c[1]}kv{c[2]}-"
                                       f"{'c' if c[3] else 'nc'}-w{c[4]}")
def test_backward_kernels_match_plain_on_card(cuda, case, d, dtype):
    x, causal, window = _card_case(case, d, dtype, cuda)
    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    o, lse = attention_lse_ref(q, k, v, causal=causal, window=window)
    dsum = (do.float() * o.float()).sum(-1)
    dq = flash_attention_dq(q, k, v, do, lse, dsum, causal=causal,
                            window=window)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                             do.float(), causal=causal, window=window)
    tol = CARD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(g.float(), w.to(g.dtype).float(),
                                   atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
def test_function_launches_the_kernels_on_card(cuda):
    x, causal, window = _card_case((100, 8, 2, True, 0), 64, "float32", cuda)
    ins = [x[n].requires_grad_() for n in "qkv"]
    before = (flash_attention_fwd_lse.launches, flash_attention_dq.launches,
              flash_attention_dkv.launches)
    out = FlashAttention.apply(*ins, causal, window)
    got = torch.autograd.grad(out, ins, x["do"])
    torch.cuda.synchronize()
    after = (flash_attention_fwd_lse.launches, flash_attention_dq.launches,
             flash_attention_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    ref_ins = [t.detach().cpu().requires_grad_() for t in ins]
    want = torch.autograd.grad(attention_ref(*ref_ins), ref_ins,
                               x["do"].cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_library_backward_route_agrees_on_card(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for d in HEAD_DIMS:
            assert library_bwd_route(dtype, d) == bwd_route(dtype, d)


# tile edges of the tensor-core backward (64-row q tiles, 64-key tiles):
# (S, G, causal, window) at Kv 2, bf16
TC_EDGE_CASES = [
    (1, 1, True, 0),
    (63, 4, True, 0),
    (64, 8, True, 0),
    (64, 4, False, 0),
    (65, 1, False, 0),
    (65, 8, True, 32),
    (127, 4, True, 32),
    (127, 1, False, 1024),
    (130, 8, False, 32),
    (130, 4, True, 1024),
    (4096, 4, True, 0),
    (4096, 8, True, 1024),
    (4096, 1, False, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", TENSOR_CORE_HEAD_DIMS)
@pytest.mark.parametrize("case", TC_EDGE_CASES,
                         ids=lambda c: f"S{c[0]}-G{c[1]}-"
                                       f"{'c' if c[2] else 'nc'}-w{c[3]}")
def test_tensor_core_backward_at_tile_edges_on_card(cuda, case, d):
    s, g, causal, window = case
    kv = 2
    c = make_case(s, d, kv * g, kv, seed=7, b=1 if s > 1000 else 2,
                  scale=0.7)
    q, k, v, do = (to_torch(c[n], "bfloat16", cuda)
                   for n in ("q", "k", "v", "do"))
    mask = dict(causal=causal, window=window)
    o, lse = attention_lse_ref(q.float(), k.float(), v.float(), **mask)
    dsum = (do.float() * o).sum(-1)
    wrappers = (flash_attention_dq, flash_attention_dkv)
    before = [dict(f.route_launches) for f in wrappers]
    dq = flash_attention_dq(q, k, v, do, lse, dsum, **mask)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dsum, **mask)
    torch.cuda.synchronize()
    for f, was in zip(wrappers, before):
        assert f.route_launches == {"tensor_core": was["tensor_core"] + 1,
                                    "cuda_core": was["cuda_core"]}
    want = attention_bwd_ref(q.float(), k.float(), v.float(), o, lse,
                             do.float(), **mask)
    tol = CARD_TOL["bfloat16"]
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(got.float(), w.to(got.dtype).float(),
                                   atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
def test_library_forward_route_agrees_on_card(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for d in HEAD_DIMS:
            assert library_fwd_route(dtype, d) == fwd_route(dtype, d)


# tile edges of the tensor-core forward (64-row q tiles, 64-key tiles):
# (S, G, causal, window) at Kv 2, bf16; windows 32 and 70 end inside a
# key tile, 64 on its edge
TC_FWD_EDGE_CASES = [
    (1, 1, True, 0),
    (1, 8, False, 0),
    (63, 4, True, 0),
    (63, 1, False, 32),
    (64, 8, True, 0),
    (64, 4, False, 0),
    (64, 1, True, 32),
    (65, 1, False, 0),
    (65, 8, True, 32),
    (65, 4, True, 64),
    (130, 8, False, 32),
    (130, 4, True, 70),
    (130, 1, True, 0),
    (4096, 8, True, 1024),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", TENSOR_CORE_HEAD_DIMS)
@pytest.mark.parametrize("case", TC_FWD_EDGE_CASES,
                         ids=lambda c: f"S{c[0]}-G{c[1]}-"
                                       f"{'c' if c[2] else 'nc'}-w{c[3]}")
def test_tensor_core_forward_at_tile_edges_on_card(cuda, case, d):
    s, g, causal, window = case
    kv = 2
    c = make_case(s, d, kv * g, kv, seed=8, b=1 if s > 1000 else 2,
                  scale=0.7)
    q, k, v = (to_torch(c[n], "bfloat16", cuda) for n in "qkv")
    mask = dict(causal=causal, window=window)
    fwds = (flash_attention, flash_attention_fwd_lse)
    before = [dict(f.route_launches) for f in fwds]
    o_only = flash_attention(q, k, v, **mask)
    o, lse = flash_attention_fwd_lse(q, k, v, **mask)
    torch.cuda.synchronize()
    for f, was in zip(fwds, before):
        assert f.route_launches == {"tensor_core": was["tensor_core"] + 1,
                                    "cuda_core": was["cuda_core"]}
    want_o, want_lse = attention_lse_ref(q.float(), k.float(), v.float(),
                                         **mask)
    tol = CARD_TOL["bfloat16"]
    for got in (o_only, o):
        torch.testing.assert_close(got.float(),
                                   want_o.to(got.dtype).float(), atol=tol,
                                   rtol=tol)
    assert torch.equal(o, o_only)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
