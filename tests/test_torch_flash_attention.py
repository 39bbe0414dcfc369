"""The port's attention (``repro_torch.kernels.flash_attention``) against the
JAX package's oracles, at the grid of ``tests/test_kernels.py``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of ``tests/test_kernels.py``: f32 2e-5 (the two
packages sum in another order), bf16 2e-2 (one rounding of the output).
The CUDA kernel itself is held against its plain version on the card in
``tests/test_torch_cuda.py``.

Gradients: the port's written-out backward (``attention_bwd_ref``), autograd
through its plain path, and ``FlashAttention`` (the wrappers' plain
versions on the CPU) against ``jax.grad`` of the reference's
``attention_ref`` and ``attention_chunked``, 1e-4 in f32 (a gradient sums
up to S or G·S terms, in another order) and bf16 2e-2.  The parts into
which the bf16 head_dim-256 dK/dV kernel splits its work
(``dkdv_partials_ref``) sum to the whole plain gradient (1e-5) and to
``jax.grad``'s (1e-4), in f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_chunked as jax_chunked
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention.kernel import (BWD_KERNELS,
                                                        MAX_BWD_SPLITS,
                                                        bwd_splits,
                                                        flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import FlashAttention, flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_chunked,
                                                     dkdv_partials_ref, lse_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRID = [  # tests/test_kernels.py
    (1, 128, 2, 2, 64, None),
    (2, 256, 4, 2, 64, None),
    (1, 256, 4, 1, 128, None),     # MQA
    (2, 256, 4, 2, 64, 64),        # local window
    (1, 512, 2, 2, 64, 128),
]
HD256 = [  # recurrentgemma-2b's head_dim, MQA, with and without a window
    (1, 128, 4, 1, 256, None),
    (1, 256, 10, 1, 256, 64),
]
RAGGED = [  # lengths and masks the Pallas kernel cannot take
    (2, 200, 4, 2, 64, None, True),     # ragged S
    (1, 1000, 4, 2, 64, 96, True),      # ragged S with a window, chunked path
    (1, 300, 4, 2, 128, None, False),   # non-causal
    (1, 5, 2, 1, 64, None, True),       # S below one block
]
# Lengths and windows that straddle the bf16 kernel's tiles (128 query rows
# and 64 keys at hd 64 and 256, 64 and 64 at hd 16 and 128):
# S one row, one short of and one past a tile; window 1 and windows whose
# first key falls inside a key tile; KH = H and KH = 1.
TILE_EDGES = [
    (1, 1, 2, 1, 64, None, True),
    (2, 15, 4, 4, 64, None, True),
    (1, 63, 4, 1, 64, None, True),
    (1, 65, 2, 2, 64, None, False),
    (1, 127, 4, 2, 64, 1, True),
    (2, 129, 4, 2, 64, 40, True),
    (1, 2049, 2, 1, 16, 300, True),
    (2, 129, 4, 4, 16, None, True),
    (1, 65, 2, 1, 16, 1, True),
    (1, 129, 4, 2, 128, 40, True),
    (1, 63, 2, 2, 128, None, False),
    (1, 65, 4, 1, 256, 1, True),
    (1, 127, 4, 2, 256, 40, True),
    (1, 129, 2, 1, 256, None, False),
]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, S, H, KH, hd, name):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd))]
    jdt, tdt = DTYPES[name]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KH,hd,window", GRID)
def test_port_vs_jax_ref_and_pallas(B, S, H, KH, hd, window, name):
    (jq, jk, jv), (q, k, v) = _inputs(S + H, B, S, H, KH, hd, name)
    got = flash_attention(q, k, v, causal=True, window=window)
    ref = jax_ref(jq, jk, jv, causal=True, window=window)
    pal = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                 interpret=True)
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(name))
    np.testing.assert_allclose(_np(got), _np(pal), **_tol(name))


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KH,hd,window", HD256)
def test_head_dim_256_vs_jax_ref_and_pallas(B, S, H, KH, hd, window, name):
    """The port's plain version (the wrapper on a CPU tensor) at head_dim
    256, against the JAX package's oracle and its Pallas kernel."""
    (jq, jk, jv), (q, k, v) = _inputs(S + hd, B, S, H, KH, hd, name)
    got = flash_attention_fwd(q, k, v, causal=True, window=window)
    ref = jax_ref(jq, jk, jv, causal=True, window=window)
    pal = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                 interpret=True)
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(name))
    np.testing.assert_allclose(_np(got), _np(pal), **_tol(name))


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KH,hd,window,causal", RAGGED)
def test_port_ragged_and_noncausal_vs_jax_ref(B, S, H, KH, hd, window, causal,
                                              name):
    (jq, jk, jv), (q, k, v) = _inputs(S, B, S, H, KH, hd, name)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    for got in (flash_attention(q, k, v, causal=causal, window=window),
                flash_attention_fwd(q, k, v, causal=causal, window=window)):
        np.testing.assert_allclose(_np(got), _np(ref), **_tol(name))


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KH,hd,window,causal", TILE_EDGES)
def test_port_at_tile_edges_vs_jax_ref(B, S, H, KH, hd, window, causal, name):
    """The port's plain path (the dispatch and the wrapper on a CPU tensor)
    against the JAX package's oracle where the bf16 kernel's tiles end."""
    (jq, jk, jv), (q, k, v) = _inputs(S + hd, B, S, H, KH, hd, name)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    for got in (flash_attention(q, k, v, causal=causal, window=window),
                flash_attention_fwd(q, k, v, causal=causal, window=window)):
        np.testing.assert_allclose(_np(got), _np(ref), **_tol(name))


@pytest.mark.parametrize("window", [None, 256])
def test_chunked_vs_jax_chunked(window):
    (jq, jk, jv), (q, k, v) = _inputs(7, 1, 1024, 4, 2, 64, "float32")
    got = attention_chunked(q, k, v, causal=True, window=window)
    ref = jax_chunked(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 4])
def test_positioned_decode_with_invalid_slots(window):
    """One query against a cache whose free slots carry position -1."""
    B, cap, H, KH, hd, pos = 2, 12, 4, 2, 16, 7
    rng = np.random.default_rng(3)
    qa = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    ka = rng.normal(size=(B, cap, KH, hd)).astype(np.float32)
    va = rng.normal(size=(B, cap, KH, hd)).astype(np.float32)
    kpos = np.array(list(range(pos + 1)) + [-1] * (cap - pos - 1), np.int32)
    ref = jax_ref(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va),
                  causal=True, window=window,
                  q_positions=jnp.asarray([pos], jnp.int32),
                  k_positions=jnp.asarray(kpos))
    got = flash_attention(torch.from_numpy(qa), torch.from_numpy(ka),
                          torch.from_numpy(va), causal=True, window=window,
                          q_positions=torch.tensor([pos]),
                          k_positions=torch.from_numpy(kpos),
                          impl="reference")
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-5, atol=2e-5)


def test_dispatch_refuses_what_the_kernel_cannot_take():
    q = torch.zeros(1, 1, 2, 64)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="contiguous positions"):
        flash_attention(q, k, k, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(k, k, k, impl="pallas")


@pytest.mark.parametrize("shapes,dtype,error", [
    (((1, 8, 2, 48), (1, 8, 2, 48)), torch.float32, "head_dim 48"),
    (((1, 8, 3, 64), (1, 8, 2, 64)), torch.float32, "head counts"),
    (((1, 8, 2, 64), (1, 9, 2, 64)), torch.float32, "Sq == Sk"),
    (((1, 8, 2, 64), (1, 8, 2, 64)), torch.float16, "float32 or bfloat16"),
    (((1, 8, 2, 64), (1, 8, 2, 64)), torch.float32, "CUDA device"),
])
def test_wrapper_checks_before_launching(shapes, dtype, error):
    """Off the CPU the wrapper checks before it touches the kernel; meta
    tensors reach those checks with no card."""
    q = torch.empty(shapes[0], dtype=dtype, device="meta")
    k = torch.empty(shapes[1], dtype=dtype, device="meta")
    before = LAUNCHES["flash_attn_fwd"]
    with pytest.raises((ValueError, TypeError), match=error):
        flash_attention_fwd(q, k, k)
    assert LAUNCHES["flash_attn_fwd"] == before


@pytest.mark.parametrize("dtype,hd,block_q", [
    (torch.float32, 64, 64), (torch.float32, 128, 32), (torch.float32, 256, 16),
    (torch.bfloat16, 64, 128), (torch.bfloat16, 256, 128),
])
def test_wrapper_checks_the_grid_of_each_kernel(dtype, hd, block_q):
    """The query tile, and so the longest S the grid takes, is the f32
    kernel's or the bf16 kernel's; one row more than 65535 tiles raises."""
    q = torch.empty((1, 65535 * block_q + 1, 1, hd), dtype=dtype, device="meta")
    before = LAUNCHES["flash_attn_fwd"]
    with pytest.raises(ValueError, match="exceed the kernel's grid"):
        flash_attention_fwd(q, q, q)
    assert LAUNCHES["flash_attn_fwd"] == before


def _grad_tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


@functools.partial(jax.jit, static_argnames=("fn", "causal", "window"))
def _jax_grads(fn, jq, jk, jv, jdo, *, causal, window):
    """jax.grad of sum(fn(q, k, v) * dO) with respect to q, k and v."""
    return jax.grad(lambda q, k, v: jnp.sum(
        fn(q, k, v, causal=causal, window=window).astype(jnp.float32)
        * jdo.astype(jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)


def _port_grads(q, k, v, do, **mask):
    """The port's three gradients: the written-out plain backward from the
    plain forward's output and log-sum-exp, autograd through the plain path,
    and FlashAttention on the CPU."""
    o = flash_attention(q, k, v, **mask)
    written = attention_bwd_ref(q, k, v, o, lse_ref(q, k, **mask), do, **mask)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    autograd = torch.autograd.grad(flash_attention(*leaves, **mask), leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    function = torch.autograd.grad(
        FlashAttention.apply(*leaves, mask["causal"], mask["window"]), leaves, do)
    return {"attention_bwd_ref": written, "autograd": autograd,
            "FlashAttention": function}


GRAD_CASES = ([c + (True,) for c in GRID] + RAGGED[:1] + RAGGED[2:]
              + TILE_EDGES[:5] + TILE_EDGES[7:9])


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KH,hd,window,causal", GRAD_CASES)
def test_gradients_vs_jax_grad_of_attention_ref(B, S, H, KH, hd, window, causal,
                                                name):
    """Windows, GQA (KH < H), MQA, KH = H, ragged and non-causal, S = 1."""
    (jq, jk, jv), (q, k, v) = _inputs(S + 3, B, S, H, KH, hd, name)
    rng = np.random.default_rng(S + 4)
    do_np = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    jdt, tdt = DTYPES[name]
    jdo, do = jnp.asarray(do_np, jdt), torch.from_numpy(do_np).to(tdt)
    mask = dict(causal=causal, window=window)
    ref = _jax_grads(jax_ref, jq, jk, jv, jdo, **mask)
    for how, got in _port_grads(q, k, v, do, **mask).items():
        for what, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == q.dtype
            np.testing.assert_allclose(_np(g), _np(r), err_msg=f"{how} {what}",
                                       **_grad_tol(name))


@pytest.mark.parametrize("window", [None, 256])
def test_gradients_vs_jax_grad_of_attention_chunked(window):
    """S = 1024, the length at which both packages' plain paths take the
    query-blocked version."""
    (jq, jk, jv), (q, k, v) = _inputs(9, 1, 1024, 4, 2, 64, "float32")
    do_np = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    mask = dict(causal=True, window=window)
    ref = _jax_grads(jax_chunked, jq, jk, jv, jnp.asarray(do_np), **mask)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attention_chunked(*leaves, **mask), leaves,
                              torch.from_numpy(do_np))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-4, atol=1e-4)
    o = attention_chunked(q, k, v, **mask)
    written = attention_bwd_ref(q, k, v, o, lse_ref(q, k, **mask),
                                torch.from_numpy(do_np), **mask)
    for g, r in zip(written, ref):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,H,KH,hd,dtype,sms,parts", [
    (1, 2048, 10, 1, 256, torch.bfloat16, 132, 8),   # recurrentgemma-2b, batch 1
    (4, 2048, 10, 1, 256, torch.bfloat16, 132, 2),   # batch 4
    (2, 2048, 10, 1, 256, torch.bfloat16, 132, 4),
    (1, 64, 10, 1, 256, torch.bfloat16, 132, 8),     # one query tile
    (1, 40, 2, 1, 256, torch.bfloat16, 132, 2),      # ... with a walk of 2 pairs
    (1, 300, 4, 2, 256, torch.bfloat16, 132, 8),     # more parts than query tiles
    (132, 2048, 10, 1, 256, torch.bfloat16, 132, 1),  # B * KH >= SMs
    (66, 64, 4, 2, 256, torch.bfloat16, 132, 2),     # B * KH = SMs, one tile a head
    (1, 2048, 10, 1, 256, torch.float32, 132, 1),    # f32: the CUDA-core kernel
    (1, 2048, 16, 8, 64, torch.bfloat16, 132, 1),    # hd 64: the four-warp kernel
])
def test_bwd_splits_fills_the_card(B, S, H, KH, hd, dtype, sms, parts):
    """Two blocks an SM, the nearest whole number of parts, at most
    MAX_BWD_SPLITS and at most the longest key tile's walk; 1 where the
    kernel does not split."""
    got = bwd_splits(B, S, H, KH, hd, dtype, sms)
    assert got == parts and 1 <= got <= MAX_BWD_SPLITS


SPLIT_CASES = [  # (B, S, H, KH, window, causal, splits) at head_dim 256
    (1, 130, 4, 1, None, True, 3),
    (1, 130, 4, 1, None, True, 8),      # more parts than a key tile's pairs
    (2, 100, 4, 2, 40, True, 2),        # KH > 1, a window inside a tile
    (1, 129, 2, 1, 1, True, 4),         # window 1: one pair a key tile
    (1, 70, 2, 1, None, False, 5),      # non-causal, ragged S
]


@pytest.mark.parametrize("B,S,H,KH,window,causal,splits", SPLIT_CASES)
def test_split_partials_sum_to_the_whole_gradient(B, S, H, KH, window, causal,
                                                  splits):
    """The parts the split dK/dV kernel writes, summed over the parts, equal
    the whole plain gradient and the reference's, ``jax.grad`` of
    sum(``attention_ref`` o dO) (its vjp with dO), in f32."""
    hd = 256
    (jq, jk, jv), (q, k, v) = _inputs(S + splits, B, S, H, KH, hd, "float32")
    do_np = np.random.default_rng(S + 1).normal(size=(B, S, H, hd)).astype(np.float32)
    mask = dict(causal=causal, window=window)
    o = flash_attention(q, k, v, **mask)
    L = lse_ref(q, k, **mask)
    do = torch.from_numpy(do_np)
    dk_part, dv_part = dkdv_partials_ref(q, k, v, o, L, do, splits=splits, **mask)
    assert dk_part.shape == dv_part.shape == (splits, B, S, KH, hd)
    _, dk, dv = attention_bwd_ref(q, k, v, o, L, do, **mask)
    _, jdk, jdv = _jax_grads(jax_ref, jq, jk, jv, jnp.asarray(do_np), **mask)
    for what, part, whole, jax_whole in (("dk", dk_part, dk, jdk),
                                         ("dv", dv_part, dv, jdv)):
        np.testing.assert_allclose(_np(part.sum(0)), _np(whole), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
        np.testing.assert_allclose(_np(part.sum(0)), _np(jax_whole), rtol=1e-4,
                                   atol=1e-4, err_msg=what)


@pytest.mark.parametrize("window", [None, 3])
def test_lse_ref_is_the_log_of_the_softmax_denominator(window):
    """exp(scale q.k - L) sums to 1 over the visible keys of every row."""
    q, k = (torch.from_numpy(np.random.default_rng(s).normal(
        size=(2, 9, 4, 16)).astype(np.float32))[:, :, :h] for s, h in ((1, 4), (2, 2)))
    L = lse_ref(q, k, causal=True, window=window)
    assert L.shape == (2, 4, 9) and L.dtype == torch.float32
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(2, 9, 2, 2, 16), k) / 4.0
    pos = torch.arange(9)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    p = torch.where(mask, torch.exp(s - L.reshape(2, 2, 2, 9, 1)), 0.0)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_cpu_wrappers_return_the_plain_lse_and_backward():
    (_, _, _), (q, k, v) = _inputs(1, 1, 33, 4, 2, 16, "float32")
    o, L = flash_attention_fwd(q, k, v, window=5, return_lse=True)
    torch.testing.assert_close(L, lse_ref(q, k, window=5), rtol=0, atol=0)
    do = torch.ones_like(q)
    for got, ref in zip(flash_attention_bwd(q, k, v, o, L, do, window=5),
                        attention_bwd_ref(q, k, v, o, L, do, window=5)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("change,error", [
    ({"o": (1, 8, 2, 32)}, "o .* must match q"),
    ({"do": (1, 8, 2, 64, "bfloat16")}, "do .* must match q"),
    ({"lse": (1, 8, 2)}, "lse .* float32 from the forward"),
    ({"lse": (1, 2, 8, "bfloat16")}, "lse .* float32 from the forward"),
    ({"q": (1, 8, 2, 48), "k": (1, 8, 2, 48), "v": (1, 8, 2, 48),
      "o": (1, 8, 2, 48), "do": (1, 8, 2, 48)}, "head_dim 48"),
    ({}, "CUDA device"),
])
def test_backward_wrapper_checks_before_launching(change, error):
    """Off the CPU the backward's wrapper checks before it touches a kernel;
    meta tensors reach those checks with no card."""
    shapes = {"q": (1, 8, 2, 64), "k": (1, 8, 2, 64), "v": (1, 8, 2, 64),
              "o": (1, 8, 2, 64), "do": (1, 8, 2, 64), "lse": (1, 2, 8, "float32")}
    shapes.update(change)
    t = {n: torch.empty(s[:-1] if isinstance(s[-1], str) else s,
                        dtype=getattr(torch, s[-1]) if isinstance(s[-1], str)
                        else torch.float32, device="meta")
         for n, s in shapes.items()}
    before = {n: LAUNCHES[n] for n in BWD_KERNELS}
    with pytest.raises((ValueError, TypeError), match=error):
        flash_attention_bwd(t["q"], t["k"], t["v"], t["o"], t["lse"], t["do"])
    assert {n: LAUNCHES[n] for n in BWD_KERNELS} == before
