"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the JAX
package's, at the grid of ``tests/test_kernels.py``.

Inputs are made with numpy from a seed, drawn as ``tests/test_kernels.py``
draws them, and handed to both packages.  Tolerances:
- the kernel's function (f32 out from f32 arithmetic on the same inputs, in
  either input type): 2e-4 abs + rel, the f32 bound of ``tests/test_kernels.py``;
- ``ops.ssd`` against the JAX package: that file's, y 2e-4 in f32 and 5e-2 in
  bf16 (one rounding of the output), final state 1e-3;
- the decode step (f32): 1e-5, the two packages differ only in the order of
  a few f32 products;
- the bf16 tensor-core path's rounding, emulated here (``_emulate``), against
  the plain path and the JAX package: y one bf16 step (8e-3 abs + rel, both
  round y to bf16 once), h_final 2e-4 abs + rel, as ``chip_smoke.py`` holds
  the kernels on the card;
- the gradient (``ssd_bwd_ref``, the backward wrappers' plain versions, and
  ``SSDScan`` on CPU tensors) against autograd through ``ssd_chunked_ref``
  and ``jax.vjp`` of the JAX package's ``ssd_chunked_ref``, f32: 1e-4 of
  each gradient's largest magnitude (``_close_scaled``), since dA, dD, dB
  and dC sum over a chunk's rows or the whole sequence, and a sum of mixed
  signs has elements far below its terms.
The CUDA kernels themselves are held against their plain versions on the
card in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_chunked_ref as jax_chunked
from repro.kernels.ssd_scan.ref import ssd_decode_step as jax_decode
from repro.kernels.ssd_scan.ref import ssd_ref as jax_sequential
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ssd_scan.kernel import (ssd_bwd_chunk, ssd_bwd_dstate,
                                                 ssd_bwd_state_pass, ssd_chunk,
                                                 ssd_chunk_scan, ssd_chunk_state,
                                                 ssd_state_pass)
from repro_torch.kernels.ssd_scan.ops import SSDScan, ssd
from repro_torch.kernels.ssd_scan.ref import (chunk_cumsum, chunk_dstate_ref,
                                              chunk_scan_ref, chunk_state_ref,
                                              pass_states, ssd_bwd_ref, ssd_chunk_ref,
                                              ssd_chunked_ref, ssd_decode_step,
                                              ssd_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRID = [  # (Bt, S, H, P, G, N, chunk): tests/test_kernels.py
    (1, 64, 2, 16, 1, 32, 16),
    (2, 128, 4, 16, 2, 32, 32),
    (1, 96, 2, 32, 1, 16, 32),
    (1, 80, 2, 16, 1, 16, 32),     # pad 80 -> 96
]
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, Bt, S, H, P, G, N, name, A=None):
    """numpy arrays drawn as tests/test_kernels.py draws them, as
    (jax arrays, torch tensors); x, B, C in ``name``, the rest f32."""
    rng = np.random.default_rng(seed)
    a = {"x": rng.normal(size=(Bt, S, H, P)),
         "dt": rng.uniform(0.1, 0.9, size=(Bt, S, H)),
         "A": -rng.uniform(0.5, 2.0, size=(H,)) if A is None else A,
         "B": rng.normal(size=(Bt, S, G, N)),
         "C": rng.normal(size=(Bt, S, G, N)),
         "D": rng.normal(size=(H,))}
    a = {k: np.asarray(v, np.float32) for k, v in a.items()}
    jdt, tdt = DTYPES[name]
    low = ("x", "B", "C")
    j = {k: jnp.asarray(v, jdt if k in low else jnp.float32) for k, v in a.items()}
    t = {k: torch.from_numpy(v).to(tdt if k in low else torch.float32)
         for k, v in a.items()}
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _args(d):
    return d["x"], d["dt"], d["A"], d["B"], d["C"], d["D"]


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", GRID[:3])
def test_chunk_ref_vs_pallas_kernel(Bt, S, H, P, G, N, chunk, name):
    """``ssd_chunk_ref`` (and the wrapper on a CPU tensor) in the model's
    layout against ``ssd_chunk_pallas`` given the reference's own transposes
    and head repeat (``repro/kernels/ssd_scan/ops.py:39-51``)."""
    j, t = _inputs(S + H, Bt, S, H, P, G, N, name)
    cum = chunk_cumsum(t["dt"], t["A"], chunk)
    rep, nc = H // G, S // chunk
    jcum = jnp.asarray(cum.numpy())
    xh = j["x"].transpose(0, 2, 1, 3).reshape(Bt * H, S, P)
    dth = j["dt"].transpose(0, 2, 1).reshape(Bt * H, S)
    cumh = jcum.transpose(0, 2, 1).reshape(Bt * H, S)
    Bh = jnp.repeat(j["B"], rep, axis=2).transpose(0, 2, 1, 3).reshape(Bt * H, S, N)
    Ch = jnp.repeat(j["C"], rep, axis=2).transpose(0, 2, 1, 3).reshape(Bt * H, S, N)
    y_pal, cin_pal = ssd_chunk_pallas(xh, dth, cumh, Bh, Ch, chunk=chunk,
                                      interpret=True)
    y_pal = np.asarray(y_pal).reshape(Bt, H, S, P).transpose(0, 2, 1, 3)
    cin_pal = np.asarray(cin_pal).reshape(Bt, H, nc, P, N).transpose(0, 2, 1, 3, 4)
    for fn in (ssd_chunk_ref, ssd_chunk):
        y, cin = fn(t["x"], t["dt"], cum, t["B"], t["C"], chunk=chunk)
        assert y.dtype == cin.dtype == torch.float32
        np.testing.assert_allclose(_np(y), y_pal, **KERNEL_TOL)
        np.testing.assert_allclose(_np(cin), cin_pal, **KERNEL_TOL)


def _ssd_tol(name):
    return dict(rtol=5e-2, atol=5e-2) if name == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", GRID)
def test_ssd_vs_jax_pallas_and_sequential(Bt, S, H, P, G, N, chunk, name):
    j, t = _inputs(S * H, Bt, S, H, P, G, N, name)
    y, h = ssd(*_args(t), chunk=chunk)
    assert y.dtype == t["x"].dtype and h.dtype == torch.float32
    y_pal, h_pal = jax_ssd(*_args(j), chunk=chunk, impl="pallas", interpret=True)
    y_seq, h_seq = jax_sequential(*_args(j))
    for y_ref, h_ref in ((y_pal, h_pal), (y_seq, h_seq)):
        np.testing.assert_allclose(_np(y), _np(y_ref), **_ssd_tol(name))
        np.testing.assert_allclose(_np(h), _np(h_ref), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("impl", ["reference", "sequential"])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", GRID)
def test_plain_impls_vs_jax(Bt, S, H, P, G, N, chunk, impl):
    """``ssd(impl="reference")`` (``ssd_chunked_ref``) and ``"sequential"``
    (``ssd_ref``), with an initial state, against the JAX package's."""
    j, t = _inputs(S + 7, Bt, S, H, P, G, N, "float32")
    h0 = np.random.default_rng(9).normal(size=(Bt, H, P, N)).astype(np.float32)
    y, h = ssd(*_args(t), chunk=chunk, h0=torch.from_numpy(h0), impl=impl)
    y_ref, h_ref = jax_ssd(*_args(j), chunk=chunk, h0=jnp.asarray(h0),
                           impl=impl)
    np.testing.assert_allclose(_np(y), _np(y_ref), **_ssd_tol("float32"))
    np.testing.assert_allclose(_np(h), _np(h_ref), rtol=1e-3, atol=1e-3)


def test_chunked_ref_matches_jax_chunked_ref():
    j, t = _inputs(3, 2, 64, 4, 16, 2, 32, "float32")
    y, h = ssd_chunked_ref(*_args(t), chunk=16)
    y_ref, h_ref = jax_chunked(*_args(j), chunk=16)
    np.testing.assert_allclose(_np(y), _np(y_ref), **KERNEL_TOL)
    np.testing.assert_allclose(_np(h), _np(h_ref), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("G", [1, 2])
def test_decode_step_vs_jax_and_continues_the_scan(G):
    """One decode step against the JAX package's, and the scan of S + 1
    tokens equals the scan of S then one decode step."""
    Bt, S, H, P, N = 2, 32, 4, 16, 16
    j, t = _inputs(G, Bt, S + 1, H, P, G, N, "float32")
    h = np.random.default_rng(4).normal(size=(Bt, H, P, N)).astype(np.float32)
    step = lambda d, hh, tt: (hh, d["x"][:, tt], d["dt"][:, tt], d["A"],
                              d["B"][:, tt], d["C"][:, tt], d["D"])
    y, h_new = ssd_decode_step(*step(t, torch.from_numpy(h), 0))
    y_ref, h_ref = jax_decode(*step(j, jnp.asarray(h), 0))
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h_new), _np(h_ref), rtol=1e-5, atol=1e-5)

    cut = {k: v[:, :S] if v.dim() > 1 else v for k, v in t.items()}
    y_all, _ = ssd_ref(*_args(t))
    _, h_S = ssd(*_args(cut), chunk=8)
    y_last, _ = ssd_decode_step(*step(t, h_S, S))
    np.testing.assert_allclose(_np(y_last), _np(y_all[:, S]), **KERNEL_TOL)


def test_model_decay_stays_finite_over_256_row_chunks():
    """mamba2-780m's A = -linspace(1, 16, H) with dt near 0.8 takes cum to
    about -3,000 within a 256-row chunk; the decay is masked before the exp,
    so nothing overflows.  Small Bt, H, P; the model's N and chunk."""
    Bt, S, H, P, G, N, chunk = 1, 512, 4, 16, 1, 32, 256
    A = -np.linspace(1.0, 16.0, H)
    j, t = _inputs(11, Bt, S, H, P, G, N, "float32", A=A)
    t["dt"] = torch.full_like(t["dt"], 0.8)
    j["dt"] = jnp.asarray(t["dt"].numpy())
    cum = chunk_cumsum(t["dt"], t["A"], chunk)
    assert cum.min().item() < -3000
    y_intra, cin = ssd_chunk(t["x"], t["dt"], cum, t["B"], t["C"], chunk=chunk)
    y, h = ssd(*_args(t), chunk=chunk)
    for out in (y_intra, cin, y, h):
        assert bool(torch.isfinite(out).all())
    y_ref, h_ref = jax_sequential(*_args(j))
    np.testing.assert_allclose(_np(y), _np(y_ref), **KERNEL_TOL)
    np.testing.assert_allclose(_np(h), _np(h_ref), rtol=1e-3, atol=1e-3)


def test_ssd_dispatch_refuses_an_unknown_impl():
    _, t = _inputs(0, 1, 16, 2, 16, 1, 16, "float32")
    with pytest.raises(ValueError, match="unknown impl"):
        ssd(*_args(t), chunk=8, impl="pallas")


@pytest.mark.parametrize("x,dt,B,chunk,error", [
    ((1, 64, 2, 48), torch.float32, (1, 64, 1, 16), 16, r"\(P, N\) = \(48, 16\)"),
    ((1, 64, 2, 64), torch.float32, (1, 64, 1, 64), 16, r"\(P, N\) = \(64, 64\)"),
    ((1, 64, 3, 16), torch.float32, (1, 64, 2, 16), 16, "head counts"),
    ((1, 80, 2, 16), torch.float32, (1, 80, 1, 16), 32, "divide"),
    ((1, 512, 2, 16), torch.float32, (1, 512, 1, 16), 512, "1..256"),
    ((1, 64, 2, 16), torch.bfloat16, (1, 64, 1, 16), 16, "dt and cum"),
    ((1, 64, 2, 16), torch.float32, (1, 64, 1, 16), 16, "CUDA device"),
])
def test_wrapper_checks_before_launching(x, dt, B, chunk, error):
    """Off the CPU the wrapper checks before it touches the kernel; meta
    tensors reach those checks with no card."""
    xt = torch.empty(x, device="meta")
    dtt = torch.empty(x[:3], dtype=dt, device="meta")
    Bm = torch.empty(B, device="meta")
    before = LAUNCHES["ssd_chunk"]
    with pytest.raises((ValueError, TypeError), match=error):
        ssd_chunk(xt, dtt, dtt, Bm, Bm, chunk=chunk)
    assert LAUNCHES["ssd_chunk"] == before


def test_wrapper_refuses_mixed_input_types():
    x = torch.empty(1, 64, 2, 16, dtype=torch.bfloat16, device="meta")
    dt = torch.empty(1, 64, 2, device="meta")
    B = torch.empty(1, 64, 1, 16, device="meta")
    with pytest.raises(TypeError, match="the same for all three"):
        ssd_chunk(x, dt, dt, B, B, chunk=16)


@pytest.mark.parametrize("x,dt,B,chunk,error", [
    ((1, 64, 2, 48), torch.bfloat16, (1, 64, 1, 16), 16, r"\(P, N\) = \(48, 16\)"),
    ((1, 64, 3, 16), torch.bfloat16, (1, 64, 2, 16), 16, "head counts"),
    ((1, 80, 2, 16), torch.bfloat16, (1, 80, 1, 16), 32, "divide"),
    ((1, 512, 2, 16), torch.bfloat16, (1, 512, 1, 16), 512, "1..256"),
    ((1, 64, 2, 16), torch.float32, (1, 64, 1, 16), 16, "bfloat16"),
    ((1, 64, 2, 16), torch.bfloat16, (1, 32, 1, 16), 16, "shapes do not match"),
    ((1, 64, 2, 16), torch.bfloat16, (1, 64, 1, 16), 16, "CUDA device"),
])
@pytest.mark.parametrize("kernel", ["ssd_chunk_state", "ssd_chunk_scan"])
def test_bf16_wrappers_check_before_launching(kernel, x, dt, B, chunk, error):
    """The tensor-core kernels' wrappers check shapes, the input type (bf16
    x, B, C only), the chunk range and the device before they touch a kernel;
    meta tensors reach those checks with no card."""
    xt = torch.empty(x, dtype=dt, device="meta")
    f32 = torch.empty(x[:3], device="meta")
    Bm = torch.empty(B, dtype=torch.bfloat16, device="meta")
    Bt, S, H, P = x
    h_ins = torch.empty(Bt, max(1, S // chunk), H, P, B[3], device="meta")
    D = torch.empty(H, device="meta")
    before = dict(LAUNCHES)
    with pytest.raises((ValueError, TypeError), match=error):
        if kernel == "ssd_chunk_state":
            ssd_chunk_state(xt, f32, D, Bm, chunk=chunk)
        else:
            ssd_chunk_scan(xt, f32, f32, Bm, Bm, D, h_ins, chunk=chunk)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("what,error", [
    ("chunk_in", "chunk_in must be"),
    ("cum", "shapes do not match"),
    ("chunk", "shapes do not match"),
    ("h0", "h0 must be"),
    ("dtype", "float32"),
    ("device", "CUDA device"),
])
def test_state_pass_wrapper_checks_before_launching(what, error):
    Bt, nc, H, P, N, chunk = 2, 3, 4, 16, 16, 8
    shapes = {"chunk_in": (Bt, nc, H, P, N), "cum": (Bt, nc * chunk, H),
              "h0": (Bt, H, P, N)}
    if what in ("chunk_in", "cum", "h0"):
        shapes[what] = shapes[what][:-1] + (shapes[what][-1] + 1,)
    if what == "chunk_in":
        shapes["chunk_in"] = shapes["chunk_in"][1:]
    t = {k: torch.empty(v, device="meta", dtype=torch.bfloat16
                        if what == "dtype" and k == "h0" else torch.float32)
         for k, v in shapes.items()}
    before = dict(LAUNCHES)
    with pytest.raises((ValueError, TypeError), match=error):
        ssd_state_pass(t["chunk_in"], t["cum"], t["h0"],
                       chunk=chunk + 1 if what == "chunk" else chunk)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("A,dtype", [((3,), torch.float32), ((2,), torch.bfloat16)])
def test_state_wrapper_checks_A(A, dtype):
    """``ssd_chunk_state`` also makes the cumsum of A.dt: A is (H,) f32."""
    x = torch.empty(1, 64, 2, 16, dtype=torch.bfloat16, device="meta")
    dt = torch.empty(1, 64, 2, device="meta")
    B = torch.empty(1, 64, 1, 16, dtype=torch.bfloat16, device="meta")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="A must be"):
        ssd_chunk_state(x, dt, torch.empty(A, dtype=dtype, device="meta"), B,
                        chunk=16)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("impl", ["auto", "reference", "sequential"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_ssd_refuses_an_unsupported_dtype(impl, dtype):
    _, t = _inputs(0, 1, 16, 2, 16, 1, 16, "float32")
    t["x"] = t["x"].to(dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd(*_args(t), chunk=8, impl=impl)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", GRID + [(1, 48, 4, 16, 2, 16, 24)])
def test_bf16_path_on_the_cpu_is_the_chunked_reference(Bt, S, H, P, G, N, chunk,
                                                       h0):
    """On CPU tensors the bf16 path's three wrappers compute their plain
    versions (``chunk_state_ref``, ``pass_states``, ``chunk_scan_ref``),
    which together are ``ssd_chunked_ref`` to the bit."""
    _, t = _inputs(S + N, Bt, S, H, P, G, N, "bfloat16")
    h = torch.from_numpy(np.random.default_rng(2).normal(
        size=(Bt, H, P, N)).astype(np.float32)) if h0 else None
    y, hf = ssd(*_args(t), chunk=chunk, h0=h)
    y_ref, hf_ref = ssd(*_args(t), chunk=chunk, h0=h, impl="reference")
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_ref)
    assert torch.equal(hf, hf_ref)
    pad = (-S) % chunk
    if not pad:  # each wrapper against its plain version
        x, dt, A, B, C, D = _args(t)
        cum = chunk_cumsum(dt, A, chunk)
        cin, cum_k = ssd_chunk_state(x, dt, A, B, chunk=chunk)
        assert torch.equal(cum_k, cum)
        assert torch.equal(cin, chunk_state_ref(x, dt, cum, B, chunk=chunk))
        h_ins, h_fin = ssd_state_pass(cin, cum, h, chunk=chunk)
        decay = torch.exp(cum[:, chunk - 1::chunk])
        for got, ref in zip((h_ins, h_fin), pass_states(cin, decay, h)):
            assert torch.equal(got, ref)
        assert torch.equal(ssd_chunk_scan(x, dt, cum, B, C, D, h_ins, chunk=chunk),
                           chunk_scan_ref(x, dt, cum, B, C, D, h_ins, chunk=chunk))


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _parts(v, split: bool):
    """v as the kernels feed it to the tensor cores: hi = bf16(v) and
    lo = bf16(v - hi), or hi alone (single rounding)."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def _emulate(x, dt, A, B, C, D, chunk, h0=None, split=True):
    """The bf16 tensor-core path's arithmetic (``csrc/ssd_bf16.cu``) in
    PyTorch: bf16 operands, exact products, f32 sums; the three f32 operands
    (the scores, x.w of chunk_in and h_in of the carry) as hi + lo, or
    rounded to bf16 once with ``split=False``.  S % chunk == 0."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2:]
    R, nc, Q = H // G, S // chunk, chunk
    dtf = dt.float()
    cum = chunk_cumsum(dtf, A, chunk)
    xf = x.float().reshape(Bt, nc, Q, H, P)
    Bf = B.float().reshape(Bt, nc, Q, G, N)
    Cf = C.float().reshape(Bt, nc, Q, G, N)
    cumf, dtr = cum.reshape(Bt, nc, Q, H), dtf.reshape(Bt, nc, Q, H)
    # ssd_chunk_state
    xw = xf * (dtr * torch.exp(cumf[:, :, -1:] - cumf))[..., None]
    chunk_in = sum(torch.einsum("bckgrp,bckgn->bcgrpn",
                                v.reshape(Bt, nc, Q, G, R, P), Bf)
                   for v in _parts(xw, split)).reshape(Bt, nc, H, P, N)
    # ssd_state_pass
    h_ins, h_final = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]),
                                 h0)
    # ssd_chunk_scan
    cb = torch.einsum("bcqgn,bckgn->bcgqk", Cf, Bf)
    cum_h = cumf.permute(0, 1, 3, 2)
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool).tril()
    L = torch.exp(torch.where(mask, diff, float("-inf")))
    scores = (L.reshape(Bt, nc, G, R, Q, Q) * cb[:, :, :, None]).reshape(
        Bt, nc, H, Q, Q) * dtr.permute(0, 1, 3, 2)[..., None, :]
    y_intra = sum(torch.matmul(v, xf.permute(0, 1, 3, 2, 4))
                  for v in _parts(scores, split)).permute(0, 1, 3, 2, 4)
    carry = sum(torch.einsum("bcqgn,bcgrpn->bcqgrp", Cf,
                             v.reshape(Bt, nc, G, R, P, N))
                for v in _parts(h_ins, split)).reshape(Bt, nc, Q, H, P)
    y = (carry * torch.exp(cumf)[..., None] + y_intra).reshape(Bt, S, H, P)
    return (y + x.float() * D[:, None]).to(x.dtype), h_final


def _excess(got, ref, tol):
    """max of |got - ref| - (tol + tol |ref|): <= 0 within the gate."""
    got, ref = _np(got), _np(ref)
    return float((np.abs(got - ref) - tol - tol * np.abs(ref)).max())


EMULATED = [  # (Bt, S, H, P, G, N, chunk)
    (2, 128, 4, 16, 1, 32, 32),
    (1, 128, 4, 16, 2, 16, 32),
    (1, 96, 4, 32, 1, 16, 24),
]


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", EMULATED)
def test_emulated_split_rounding_meets_the_gates(Bt, S, H, P, G, N, chunk):
    """The kernels' hi + lo rounding, with the model's A, against the plain
    path and against the JAX package's ``ssd`` (its Pallas kernel in
    interpret mode): y within one bf16 step, h_final within 2e-4."""
    A = -np.linspace(1.0, 16.0, H)
    j, t = _inputs(S + P, Bt, S, H, P, G, N, "bfloat16", A=A)
    h0 = np.random.default_rng(3).normal(size=(Bt, H, P, N)).astype(np.float32)
    y, h = _emulate(*_args(t), chunk, h0=torch.from_numpy(h0))
    y_ref, h_ref = ssd_chunked_ref(*_args(t), chunk=chunk, h0=torch.from_numpy(h0))
    y_pal, h_pal = jax_ssd(*_args(j), chunk=chunk, h0=jnp.asarray(h0),
                           impl="pallas", interpret=True)
    for yr, hr in ((y_ref, h_ref), (y_pal, h_pal)):
        assert _excess(y, yr, 8e-3) <= 0
        assert _excess(h, hr, 2e-4) <= 0


def test_the_split_is_needed_at_the_serving_widths():
    """Why the kernels split each f32 operand into hi + lo: at mamba2-780m's
    P, N and chunk (4 heads, the model's A), the split meets both gates, and
    the same arithmetic with each f32 operand rounded to bf16 once moves y
    past one bf16 step and h_final past 2e-4 (both in any one case)."""
    Bt, S, H, P, G, N, chunk = 1, 256, 4, 64, 1, 128, 256
    _, t = _inputs(1, Bt, S, H, P, G, N, "bfloat16", A=-np.linspace(1.0, 16.0, H))
    y_ref, h_ref = ssd_chunked_ref(*_args(t), chunk=chunk)
    y, h = _emulate(*_args(t), chunk)
    assert _excess(y, y_ref, 8e-3) <= 0 and _excess(h, h_ref, 2e-4) <= 0
    y1, h1 = _emulate(*_args(t), chunk, split=False)
    assert _excess(y1, y_ref, 8e-3) > 0 and _excess(h1, h_ref, 2e-4) > 0


BWD_RTOL = 1e-4


def _emulate_dstate(dy, cum, C, chunk, split=True):
    """The bf16 ``ssd_bwd_dstate`` kernel's arithmetic (``csrc/ssd_bf16.cu``)
    in PyTorch: dy exp(cum) formed in f32 and fed to the tensor cores as
    hi + lo bf16 (or hi alone with ``split=False``), times bf16 C, exact
    products, f32 sums."""
    Bt, S, H, P = dy.shape
    G, N = C.shape[2:]
    nc = S // chunk
    dyw = dy.float() * torch.exp(cum)[..., None]
    Cf = C.float().reshape(Bt, nc, chunk, G, N)
    return sum(torch.einsum("bcqgrp,bcqgn->bcgrpn",
                            v.reshape(Bt, nc, chunk, G, H // G, P), Cf)
               for v in _parts(dyw, split)).reshape(Bt, nc, H, P, N)


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", [
    (1, 256, 4, 64, 1, 128, 256),   # mamba2-780m's P, N and chunk
    (2, 128, 4, 16, 2, 32, 32),
    (1, 96, 6, 32, 3, 16, 24),      # a chunk that is not a multiple of 16
])
def test_emulated_dstate_split_meets_the_bwd_gates(Bt, S, H, P, G, N, chunk):
    """The bf16 dS kernel's hi + lo split of dy exp(cum), times bf16 C, with
    the model's A, against ``chunk_dstate_ref``: within the SSD backward's
    bf16 gate (2e-2 of the largest magnitude), and within its f32 one
    (1e-4), which dy exp(cum) rounded to bf16 once misses."""
    rng = np.random.default_rng(S + H)
    A = torch.from_numpy(-np.linspace(1.0, 16.0, H).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, size=(Bt, S, H)).astype(np.float32))
    cum = chunk_cumsum(dt, A, chunk)
    dy, C = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             .to(torch.bfloat16) for shape in ((Bt, S, H, P), (Bt, S, G, N)))
    ref = chunk_dstate_ref(dy, cum, C, chunk=chunk)
    scale = ref.abs().max().item()
    err = (_emulate_dstate(dy, cum, C, chunk) - ref).abs().max().item()
    assert err <= 2e-2 * scale and err <= BWD_RTOL * scale
    once = (_emulate_dstate(dy, cum, C, chunk, split=False) - ref).abs().max().item()
    assert BWD_RTOL * scale < once <= 2e-2 * scale


GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
BWD_CASES = [  # (Bt, S, H, P, G, N, chunk, model A)
    (1, 64, 2, 16, 1, 32, 16, False),
    (2, 32, 4, 16, 2, 16, 8, False),     # the reduced configs' (P, N, chunk)
    (1, 48, 6, 16, 3, 16, 24, False),
    (1, 256, 2, 16, 1, 16, 128, True),   # cum below -1,000 within a chunk
]


def _close_scaled(got, ref, what):
    """max |got - ref| <= BWD_RTOL max |ref|."""
    got, ref = _np(got), _np(ref)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert got.shape == ref.shape and err <= BWD_RTOL * scale, \
        f"{what}: max|err| {err:.3e}, max|ref| {scale:.3e}"


def _bwd_case(seed, Bt, S, H, P, G, N, model_a):
    """f32 inputs (dt in [0.6, 0.9] with the model's A, so that cum falls
    below -1,000 in a 128-row chunk), h0, dy and dh_final, as (jax, torch)."""
    A = -np.linspace(1.0, 16.0, H) if model_a else None
    j, t = _inputs(seed, Bt, S, H, P, G, N, "float32", A=A)
    rng = np.random.default_rng(seed + 1)
    if model_a:
        dt = rng.uniform(0.6, 0.9, size=(Bt, S, H)).astype(np.float32)
        j["dt"], t["dt"] = jnp.asarray(dt), torch.from_numpy(dt)
    for k, shape in (("h0", (Bt, H, P, N)), ("dy", (Bt, S, H, P)),
                     ("dhf", (Bt, H, P, N))):
        v = rng.normal(size=shape).astype(np.float32)
        j[k], t[k] = jnp.asarray(v), torch.from_numpy(v)
    return j, t


def _jax_grads(j, chunk):
    fn = jax.jit(lambda x, dt, A, B, C, D, h0, dy, dhf: jax.vjp(
        lambda *a: jax_chunked(*a[:6], chunk=chunk, h0=a[6]),
        x, dt, A, B, C, D, h0)[1]((dy, dhf)))
    return fn(*_args(j), j["h0"], j["dy"], j["dhf"])


def _autograd_grads(t, chunk, fn=ssd_chunked_ref):
    leaves = [v.clone().requires_grad_() for v in (*_args(t), t["h0"])]
    y, h = fn(*leaves[:6], chunk=chunk, h0=leaves[6])
    return torch.autograd.grad([y, h], leaves, [t["dy"], t["dhf"]])


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,model_a", BWD_CASES)
def test_bwd_ref_vs_autograd_and_jax_grad(Bt, S, H, P, G, N, chunk, model_a):
    """``ssd_bwd_ref`` from the forward's saved cum and h_ins, and the three
    backward wrappers on CPU tensors, against autograd through
    ``ssd_chunked_ref`` and ``jax.vjp`` of the JAX package's
    ``ssd_chunked_ref``: every input's gradient, h0's included."""
    j, t = _bwd_case(S + H, Bt, S, H, P, G, N, model_a)
    x, dt, A, B, C, D = _args(t)
    cum = chunk_cumsum(dt, A, chunk)
    if model_a:
        assert cum.min().item() < -1000
    _, chunk_in = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    h_ins, _ = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]), t["h0"])
    got = ssd_bwd_ref(x, dt, A, B, C, D, cum, h_ins, t["dy"], t["dhf"],
                      chunk=chunk)
    dS = ssd_bwd_dstate(t["dy"], cum, C, chunk=chunk)
    dchunk_in, dh0, end = ssd_bwd_state_pass(dS, cum, h_ins, t["dhf"],
                                             chunk=chunk)
    wrapped = (*ssd_bwd_chunk(x, dt, A, cum, B, C, D, t["dy"], h_ins, dchunk_in,
                              end, chunk=chunk), dh0)
    ref = _autograd_grads(t, chunk)
    jref = _jax_grads(j, chunk)
    for what, g, w, r, jr in zip(GRAD_NAMES, got, wrapped, ref, jref):
        assert bool(torch.isfinite(g).all()), what
        assert torch.equal(g, w), what
        _close_scaled(g, r, what)
        _close_scaled(g, jr, what)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,model_a", BWD_CASES[:2])
def test_ssd_function_on_cpu_matches_autograd(Bt, S, H, P, G, N, chunk, model_a,
                                              name):
    """``SSDScan`` on CPU tensors (forward through the path of the input
    type, backward through the wrappers' plain versions) against autograd
    through ``ssd_chunked_ref`` from the same inputs: f32 within BWD_RTOL;
    bf16 x, B, C (and their gradients, rounded once to bf16 on both sides)
    within one bf16 step, 8e-3 of the largest magnitude."""
    _, t = _bwd_case(S * G, Bt, S, H, P, G, N, model_a)
    if name == "bfloat16":
        for k in ("x", "B", "C", "dy"):
            t[k] = t[k].to(torch.bfloat16)
    got = _autograd_grads(t, chunk,
                          lambda *a, chunk, h0: SSDScan.apply(*a, h0, chunk))
    ref = _autograd_grads(t, chunk)
    for what, g, r in zip(GRAD_NAMES, got, ref):
        assert g.dtype == r.dtype, what
        if name == "float32":
            _close_scaled(g, r, what)
        else:
            err = np.abs(_np(g) - _np(r)).max()
            assert err <= 8e-3 * np.abs(_np(r)).max(), what


@pytest.mark.parametrize("kernel,what,error", [
    ("ssd_bwd_dstate", "pn", r"\(P, N\) = \(48, 16\)"),
    ("ssd_bwd_dstate", "dtype", "the same for all three"),
    ("ssd_bwd_dstate", "device", "CUDA device"),
    ("ssd_bwd_state_pass", "shape", "shapes do not match"),
    ("ssd_bwd_state_pass", "dh_final", "dh_final must be"),
    ("ssd_bwd_state_pass", "dtype", "float32"),
    ("ssd_bwd_state_pass", "device", "CUDA device"),
    ("ssd_bwd_chunk", "pn", r"\(P, N\) = \(48, 16\)"),
    ("ssd_bwd_chunk", "dy", "dy .* must match x"),
    ("ssd_bwd_chunk", "end_term", "end_term"),
    ("ssd_bwd_chunk", "dtype", "must be float32"),
    ("ssd_bwd_chunk", "device", "CUDA device"),
])
def test_bwd_wrappers_check_before_launching(kernel, what, error):
    """The backward's wrappers check shapes, types and the device before
    they touch a kernel; meta tensors reach those checks with no card."""
    Bt, S, H, G, chunk = 1, 64, 2, 1, 16
    P = 48 if what == "pn" else 16
    N, nc = 16, S // chunk
    m = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    x, dy = m(Bt, S, H, P), m(Bt, S, H, P)
    f32, BC = m(Bt, S, H), m(Bt, S, G, N)
    states, hn = m(Bt, nc, H, P, N), m(H)
    end = m(Bt, nc, H)
    dhf = m(Bt, H, P, N)
    if what == "dtype" and kernel == "ssd_bwd_dstate":
        BC = m(Bt, S, G, N, dtype=torch.bfloat16)
    if what == "dtype" and kernel != "ssd_bwd_dstate":
        dhf = m(Bt, H, P, N, dtype=torch.bfloat16)
        hn = m(H, dtype=torch.bfloat16)
    if what == "shape":
        states = m(Bt, nc, H, P, N + 4)
    if what == "dh_final":
        dhf = m(Bt, H, P + 1, N)
    if what == "dy":
        dy = m(Bt, S, H, P, dtype=torch.bfloat16)
    if what == "end_term":
        end = m(Bt, nc + 1, H)
    before = dict(LAUNCHES)
    with pytest.raises((ValueError, TypeError), match=error):
        if kernel == "ssd_bwd_dstate":
            ssd_bwd_dstate(dy, f32, BC, chunk=chunk)
        elif kernel == "ssd_bwd_state_pass":
            ssd_bwd_state_pass(states, f32, m(Bt, nc, H, P, N), dhf, chunk=chunk)
        else:
            ssd_bwd_chunk(x, f32, hn, f32, BC, BC, hn, dy, states, states, end,
                          chunk=chunk)
    assert dict(LAUNCHES) == before
