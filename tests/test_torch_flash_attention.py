"""The port's attention (``repro_torch.kernels.flash_attention``) against the
JAX package's oracles, at the grid of ``tests/test_kernels.py``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of ``tests/test_kernels.py``: f32 2e-5 (the two
packages sum in another order), bf16 2e-2 (one rounding of the output).
The CUDA kernel itself is held against its plain version on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_chunked as jax_chunked
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_chunked

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
    (torch.float32, 64, 64), (torch.float32, 256, 16),
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
