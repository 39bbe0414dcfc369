"""The port's RG-LRU scan (``repro_torch.kernels.rglru_scan``) against the JAX
package's, at the grid of ``tests/test_kernels.py``.

Inputs are made with numpy from a seed, drawn as ``tests/test_kernels.py``
draws them (a in [0.5, 0.999), u and h0 normal), and handed to both
packages.  Tolerances, abs + rel:
- f32 1e-4 (``tests/test_kernels.py``'s): the packages take the recurrence's
  f32 products and sums in another order (or fused) at most;
- h_seq from bf16 inputs 8e-3: both sides compute in f32 from the same bf16
  inputs and round the output to bf16 once, so they differ by at most one
  bf16 step, 2**-7 |h| < 8e-3 |h|;
- h_final is f32 on both sides whatever the input type: 1e-4.
The CUDA kernel itself is held against ``rglru_scan_ref`` on the card in
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.kernel import rglru_scan_pallas
from repro.kernels.rglru_scan.ref import rglru_scan_assoc as jax_assoc
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_assoc, rglru_scan_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRID = [  # (B, S, R, block_r, block_s): tests/test_kernels.py
    (1, 64, 64, 64, 16),
    (2, 128, 128, 64, 32),
    (2, 96, 192, 96, 32),
]
F32 = dict(rtol=1e-4, atol=1e-4)


def _tol(name):
    return dict(rtol=8e-3, atol=8e-3) if name == "bfloat16" else F32


def _inputs(seed, B, S, R, name, h0=True):
    """(jax a, u, h0), (torch a, u, h0); a and u in ``name``, h0 f32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, size=(B, S, R)).astype(np.float32)
    u = rng.normal(size=(B, S, R)).astype(np.float32)
    h = rng.normal(size=(B, R)).astype(np.float32) if h0 else None
    jdt, tdt = DTYPES[name]
    return ((jnp.asarray(a, jdt), jnp.asarray(u, jdt),
             None if h is None else jnp.asarray(h)),
            (torch.from_numpy(a).to(tdt), torch.from_numpy(u).to(tdt),
             None if h is None else torch.from_numpy(h)))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,S,R,br,bs", GRID)
def test_port_vs_jax_ref_and_pallas(B, S, R, br, bs, name):
    (ja, ju, jh), (a, u, h0) = _inputs(S + R, B, S, R, name)
    hs, h_final = rglru_scan(a, u, h0)
    ref, ref_final = jax_ref(ja, ju, jh)
    pal = rglru_scan_pallas(ja, ju, jh, block_r=br, block_s=bs, interpret=True)
    assert hs.dtype == u.dtype and h_final.dtype == torch.float32
    np.testing.assert_allclose(_np(hs), _np(ref), **_tol(name))
    np.testing.assert_allclose(_np(hs), _np(pal), **_tol(name))
    np.testing.assert_allclose(_np(h_final), _np(ref_final), **F32)


@pytest.mark.parametrize("h0", [True, False])
@pytest.mark.parametrize("B,S,R,br,bs", GRID)
def test_assoc_vs_jax_assoc(B, S, R, br, bs, h0):
    """The model's plain path (``impl="reference"``) against the JAX
    package's path off the TPU, both log-depth scans in f32."""
    (ja, ju, jh), (a, u, th) = _inputs(S, B, S, R, "float32", h0)
    refs = jax.jit(jax_assoc)(ja, ju, jh)
    for got, ref in zip(rglru_scan(a, u, th, impl="reference"), refs):
        np.testing.assert_allclose(_np(got), _np(ref), **F32)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,S,R,h0", [
    (2, 300, 100, True),   # ragged S and R: no block of either to divide them
    (1, 37, 5, False),     # h0 None: zeros
    (3, 1, 8, True),       # one step
])
def test_ragged_and_zero_state_vs_jax_ref(B, S, R, h0, name):
    """Shapes the Pallas kernel cannot take, against the JAX oracle; every
    entry point of the port (wrapper, sequential, log-depth)."""
    (ja, ju, jh), (a, u, th) = _inputs(S * R, B, S, R, name, h0)
    ref, ref_final = jax_ref(ja, ju, jh)
    for impl in ("auto", "sequential", "reference"):
        hs, h_final = rglru_scan(a, u, th, impl=impl)
        np.testing.assert_allclose(_np(hs), _np(ref), **_tol(name))
        np.testing.assert_allclose(_np(h_final), _np(ref_final), **F32)


def test_final_state_is_f32_from_the_recurrence_not_the_rounded_output():
    """bf16 inputs: h_final is the f32 state (the JAX oracle's), not
    h_seq[:, -1] rounded to bf16 (the reference's Pallas path, its
    ``ops.py:23``)."""
    (ja, ju, jh), (a, u, h0) = _inputs(11, 2, 64, 128, "bfloat16")
    hs, h_final = rglru_scan_ref(a, u, h0)
    _, ref_final = jax_ref(ja, ju, jh)
    assert h_final.dtype == torch.float32
    np.testing.assert_allclose(_np(h_final), _np(ref_final), rtol=1e-6, atol=1e-6)
    rounded = hs[:, -1].float()
    assert not torch.equal(rounded, h_final)
    assert torch.equal(rounded, h_final.to(torch.bfloat16).float())


def test_sequential_and_assoc_agree_over_long_sequences():
    """S = 2048 (the serving length) with the model's kind of decay,
    a = exp(-8 softplus(1) sigmoid(z)), from about 3e-5 to 1."""
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.normal(size=(1, 2048, 16)).astype(np.float32))
    a = torch.exp(-8 * torch.nn.functional.softplus(torch.tensor(1.0))
                  * torch.sigmoid(z))
    u = torch.sqrt(1 - a * a) * torch.from_numpy(
        rng.normal(size=(1, 2048, 16)).astype(np.float32))
    for got, ref in zip(rglru_scan_assoc(a, u), rglru_scan_ref(a, u)):
        np.testing.assert_allclose(_np(got), _np(ref), **F32)


@pytest.mark.parametrize("a_shape,u_shape,dt,h0,error", [
    ((1, 8, 4), (1, 8, 5), torch.float32, None, "the same shape"),
    ((8, 4), (8, 4), torch.float32, None, r"\(B, S, R\)"),
    ((1, 0, 4), (1, 0, 4), torch.float32, None, "bad sizes"),
    ((1, 8, 4), (1, 8, 4), torch.float16, None, "float32 or bfloat16"),
    ((1, 8, 4), (1, 8, 4), torch.float32, ((1, 5), torch.float32), r"h0 \(1, 5\)"),
    ((1, 8, 4), (1, 8, 4), torch.float32, ((1, 4), torch.bfloat16), "h0 must be float32"),
    ((1, 8, 4), (1, 8, 4), torch.float32, ((1, 4), torch.float32), "CUDA device"),
])
def test_wrapper_checks_before_launching(a_shape, u_shape, dt, h0, error):
    """Off the CPU the wrapper checks before it touches the kernel; meta
    tensors reach those checks with no card."""
    a = torch.empty(a_shape, dtype=dt, device="meta")
    u = torch.empty(u_shape, dtype=dt, device="meta")
    h = None if h0 is None else torch.empty(h0[0], dtype=h0[1], device="meta")
    before = LAUNCHES["rglru_scan"]
    with pytest.raises((ValueError, TypeError), match=error):
        rglru_scan_fwd(a, u, h)
    assert LAUNCHES["rglru_scan"] == before


def test_mixed_input_types_and_unknown_impl_raise():
    a = torch.empty(1, 8, 4, device="meta")
    with pytest.raises(TypeError, match="the same for a and u"):
        rglru_scan_fwd(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown impl"):
        rglru_scan(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3), impl="pallas")
