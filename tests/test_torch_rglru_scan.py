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
- h_final is f32 on both sides whatever the input type: 1e-4;
- the gradient (``rglru_scan_bwd_ref``, the wrappers' plain version, and
  ``RGLRUScan`` on CPU tensors) against autograd through ``rglru_scan_ref``
  and against ``jax.vjp`` of the JAX package's ``rglru_scan_assoc``, f32:
  1e-5 abs + rel, the f32 bound of the recurrence's sums taken in another
  order.
The CUDA kernels themselves are held against their plain versions on the
card in ``tests/test_torch_cuda.py``.
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
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd, rglru_scan_fwd
from repro_torch.kernels.rglru_scan.ops import RGLRUScan, rglru_scan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_assoc,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_ref)

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


BWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_CASES = [  # (B, S, R, h0, dh_final)
    (1, 64, 64, True, True),
    (2, 96, 48, False, True),
    (2, 37, 5, True, False),
    (1, 1, 8, False, False),
]


def _bwd_inputs(seed, B, S, R, h0, dh_final):
    """numpy a, u, h0, dh_seq, dh_final (a in [0.5, 0.999) as the forward
    tests draw it), f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (rng.uniform(0.5, 0.999, size=(B, S, R)).astype(np.float32),
            f(B, S, R), f(B, R) if h0 else None, f(B, S, R),
            f(B, R) if dh_final else None)


@jax.jit
def _jax_grads(a, u, h0, dh, dhf):
    """jax.vjp of the JAX package's log-depth scan: (da, du, dh0)."""
    return jax.vjp(jax_assoc, a, u, h0)[1]((dh, dhf))


def _autograd(a, u, h0, dh, dhf, fn=rglru_scan_ref):
    """Gradients of <h_seq, dh> + <h_final, dh_final> by autograd through
    ``fn``: (da, du, dh0 or None)."""
    leaves = [torch.from_numpy(v).requires_grad_() if v is not None else None
              for v in (a, u, h0)]
    hs, hf = fn(*leaves)
    outs, grads = [hs], [torch.from_numpy(dh)]
    if dhf is not None:
        outs.append(hf)
        grads.append(torch.from_numpy(dhf))
    want = [t for t in leaves if t is not None]
    got = torch.autograd.grad(outs, want, grads)
    return got if h0 is not None else (*got, None)


@pytest.mark.parametrize("B,S,R,h0,dhf", BWD_CASES)
def test_bwd_ref_vs_autograd_and_jax_grad(B, S, R, h0, dhf):
    """``rglru_scan_bwd_ref`` (and the wrapper on CPU tensors) against
    autograd through ``rglru_scan_ref`` and against ``jax.vjp`` of the JAX
    package's ``rglru_scan_assoc``: the gradients of a, u and h0."""
    a, u, h, dh, dhfin = _bwd_inputs(S * R + B, B, S, R, h0, dhf)
    th = None if h is None else torch.from_numpy(h)
    hs, _ = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(u), th)
    h_prev = torch.cat([torch.zeros(B, 1, R) if th is None else th[:, None],
                        hs[:, :-1]], dim=1)
    tdhf = None if dhfin is None else torch.from_numpy(dhfin)
    got = rglru_scan_bwd_ref(torch.from_numpy(a), h_prev, torch.from_numpy(dh),
                             tdhf)
    wrapped = rglru_scan_bwd(torch.from_numpy(a), hs, th, torch.from_numpy(dh),
                             tdhf)
    ref = _autograd(a, u, h, dh, dhfin)
    jh = jnp.zeros((B, R), jnp.float32) if h is None else jnp.asarray(h)
    jdhf = jnp.zeros((B, R), jnp.float32) if dhfin is None else jnp.asarray(dhfin)
    jgrads = _jax_grads(jnp.asarray(a), jnp.asarray(u), jh, jnp.asarray(dh), jdhf)
    for i, what in enumerate(("da", "du", "dh0")):
        if what == "dh0" and h is None:
            continue
        for g in (got[i], wrapped[i]):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_np(g), _np(ref[i]), err_msg=what, **BWD_TOL)
            np.testing.assert_allclose(_np(g), _np(jgrads[i]), err_msg=what,
                                       **BWD_TOL)


@pytest.mark.parametrize("h0", [True, False])
def test_scan_function_on_cpu_matches_autograd_of_the_plain_path(h0):
    """``RGLRUScan`` on CPU tensors (its forward and backward through the
    wrappers' plain versions) against autograd through the model's plain
    path, ``rglru_scan_assoc``; the long sequence with the model's decay."""
    B, S, R = 2, 2048, 8
    rng = np.random.default_rng(21)
    a = np.exp(-8 * np.log1p(np.e) / (1 + np.exp(-rng.normal(size=(B, S, R)))))
    u = np.sqrt(1 - a * a) * rng.normal(size=(B, S, R))
    a, u = a.astype(np.float32), u.astype(np.float32)
    h = rng.normal(size=(B, R)).astype(np.float32) if h0 else None
    dh, dhf = (rng.normal(size=s).astype(np.float32) for s in ((B, S, R), (B, R)))
    leaves = [torch.from_numpy(v).requires_grad_() if v is not None else None
              for v in (a, u, h)]
    hs, hf = RGLRUScan.apply(*leaves)
    got = torch.autograd.grad([hs, hf], [t for t in leaves if t is not None],
                              [torch.from_numpy(dh), torch.from_numpy(dhf)])
    ref = _autograd(a, u, h, dh, dhf, rglru_scan_assoc)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), **BWD_TOL)


def test_scan_function_saves_f32_states_for_bf16_inputs():
    """bf16 a and u: the backward reads the f32 states, not the bf16 h_seq,
    so its gradients are autograd's through the f32 loop on the same
    values, rounded once to bf16."""
    (_, _, _), (a, u, h0) = _inputs(5, 2, 64, 16, "bfloat16")
    leaves = [t.clone().requires_grad_() for t in (a, u, h0)]
    hs, _ = RGLRUScan.apply(*leaves)
    dh = torch.from_numpy(np.random.default_rng(6).normal(
        size=hs.shape).astype(np.float32)).to(torch.bfloat16)
    got = torch.autograd.grad(hs, leaves, dh)
    ref = _autograd(a.float().numpy(), u.float().numpy(), h0.numpy(),
                    dh.float().numpy(), None)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for g, r in zip(got, ref):
        assert torch.equal(g, r.to(g.dtype))


@pytest.mark.parametrize("what,error", [
    ("dh_seq", "dh_seq .* must be"),
    ("dtype", "the same for a and dh_seq"),
    ("h_state", "h_state"),
    ("dh_final", "dh_final"),
    ("h0", r"h0 \(1, 5\)"),
    ("device", "CUDA device"),
])
def test_backward_wrapper_checks_before_launching(what, error):
    """The backward's wrapper checks shapes and types off the CPU before it
    touches the kernel; meta tensors reach those checks with no card."""
    B, S, R = 1, 8, 4
    m = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    args = {"a": m(B, S, R), "h_state": m(B, S, R), "h0": m(B, R),
            "dh_seq": m(B, S, R), "dh_final": m(B, R)}
    if what == "dh_seq":
        args["dh_seq"] = m(B, S, R + 1)
    elif what == "dtype":
        args["dh_seq"] = m(B, S, R, dtype=torch.bfloat16)
    elif what == "h_state":
        args["h_state"] = m(B, S, R, dtype=torch.bfloat16)
    elif what == "dh_final":
        args["dh_final"] = m(B, R + 1)
    elif what == "h0":
        args["h0"] = m(B, R + 1)
    before = LAUNCHES["rglru_scan_bwd"]
    with pytest.raises((ValueError, TypeError), match=error):
        rglru_scan_bwd(**args)
    assert LAUNCHES["rglru_scan_bwd"] == before
