"""The RG-LRU scan in chunks (``repro_torch.kernels.rglru_scan``): the plain
mirrors of the CUDA kernels' chunked arithmetic (``rglru_scan_chunked_ref``,
``rglru_scan_bwd_chunked_ref``) against the sequential oracles, an f64 walk
and the JAX package's ``rglru_scan_ref``, and the CPU wrappers against the
mirrors.  The kernels themselves are held against the mirrors in
``tests/test_torch_cuda_emu.py`` (their C++ on the CPU) and on the card.

Inputs are made with numpy from a seed: ``chip_smoke.py``'s grid (a in
[0.5, 0.999), u and h0 normal) and the model's decay a = exp(-8 softplus(1)
sigmoid(z)) with u = sqrt(1 - a^2) z'.  Tolerances, abs + rel:
- against the sequential oracles, 1e-5 on f32 outputs (``RGLRU_TOL``: the
  chunks' f32 products and sums are taken in another order where chunks
  meet) and one bf16 step, 8e-3, on bf16 h_seq, da and du;
- against an f64 walk, the chunked error at most 1.1 times the sequential
  oracle's own (largest and mean);
- against the JAX package's ``rglru_scan_ref`` (jnp on the CPU), 1e-4, the
  f32 bound of ``tests/test_torch_rglru_scan.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rglru_scan.kernel import (FULL_CHAINS, MIN_CHUNK,
                                                   UNROLL, chunk_length,
                                                   n_chunks, rglru_scan_bwd,
                                                   rglru_scan_fwd)
from repro_torch.kernels.rglru_scan.ops import RGLRUScan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_chunked_ref,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_chunked_ref,
                                                rglru_scan_ref)

RGLRU_TOL = 1e-5
BF16_TOL = 8e-3
# (B, S, R, h0, model a, chunk): chip_smoke.py's grid with chunks that do and
# do not divide S, a chunk of one step, and the model's decay at S 2048 in
# the 80-step chunks the wrapper takes at recurrentgemma-2b's training batch
GRID = [
    (1, 64, 64, True, False, 16),
    (2, 128, 128, True, False, 48),
    (2, 96, 192, True, False, 64),
    (2, 300, 100, True, False, 64),
    (1, 37, 5, False, False, 16),
    (1, 37, 5, True, False, 1),
    (2, 2048, 16, False, True, 80),
    (1, 2048, 24, True, True, 64),
]


def _inputs(seed, B, S, R, h0, model_a, dtype=torch.float32):
    """a, u, h0 (or None), dh_seq, dh_final: a, u, dh_seq in ``dtype``."""
    rng = np.random.default_rng(seed)
    if model_a:
        a = np.exp(-8 * np.log1p(np.e) / (1 + np.exp(-rng.normal(size=(B, S, R)))))
        u = np.sqrt(1 - a * a) * rng.normal(size=(B, S, R))
    else:
        a = rng.uniform(0.5, 0.999, size=(B, S, R))
        u = rng.normal(size=(B, S, R))
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    return (t(a).to(dtype), t(u).to(dtype),
            t(rng.normal(size=(B, R))) if h0 else None,
            t(rng.normal(size=(B, S, R))).to(dtype), t(rng.normal(size=(B, R))))


def _h_prev(hs, h0):
    first = torch.zeros_like(hs[:, :1]) if h0 is None else h0[:, None]
    return torch.cat([first, hs.float()[:, :-1]], dim=1)


def _within(what, got, ref, tol):
    d = (got.float() - ref.float()).abs()
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert bool(torch.isfinite(got.float()).all()), what
    excess = (d - tol - tol * ref.float().abs()).max().item()
    assert excess <= 0, f"{what}: max|err| {d.max().item():.3e} (tol {tol:g})"


def test_mirrors_are_the_oracles_at_one_chunk():
    """chunk >= S: one chunk, the sequential loops' operations in their
    order, so the same bits, forward and backward, f32 and bf16."""
    for i, (B, S, R, h0, model_a, _), dtype in [
            (i, case, dtype) for i, case in enumerate(GRID)
            for dtype in (torch.float32, torch.bfloat16)]:
        a, u, h, dh, dhf = _inputs(i, B, S, R, h0, model_a, dtype)
        ref = rglru_scan_ref(a, u, h)
        h_prev = _h_prev(rglru_scan_ref(a.float(), u.float(), h)[0], h)
        ref_bwd = rglru_scan_bwd_ref(a, h_prev, dh, dhf)
        for chunk in (S, S + 1, 10 * S):
            for got, want in zip(rglru_scan_chunked_ref(a, u, h, chunk), ref):
                assert torch.equal(got, want), (B, S, R, chunk)
            for got, want in zip(rglru_scan_bwd_chunked_ref(a, h_prev, dh, dhf,
                                                            chunk), ref_bwd):
                assert torch.equal(got, want), (B, S, R, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_mirror_within_tol_of_the_oracle(dtype):
    """h_seq and h_final in chunks against ``rglru_scan_ref``, over the grid,
    with and without h0."""
    for i, (B, S, R, h0, model_a, chunk) in enumerate(GRID):
        for with_h0 in (h0, not h0):
            a, u, h, _, _ = _inputs(100 + i, B, S, R, with_h0, model_a, dtype)
            hs, hf = rglru_scan_chunked_ref(a, u, h, chunk)
            ref, ref_final = rglru_scan_ref(a, u, h)
            what = f"{(B, S, R, with_h0, model_a, chunk)} {dtype}"
            _within(f"h_seq {what}", hs, ref,
                    BF16_TOL if dtype == torch.bfloat16 else RGLRU_TOL)
            _within(f"h_final {what}", hf, ref_final, RGLRU_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_mirror_within_tol_of_the_oracle(dtype):
    """da, du and dh0 in chunks against ``rglru_scan_bwd_ref`` from the same
    f32 states, over the grid, with and without dh_final."""
    for i, (B, S, R, h0, model_a, chunk) in enumerate(GRID):
        a, u, h, dh, dhf = _inputs(200 + i, B, S, R, h0, model_a, dtype)
        h_prev = _h_prev(rglru_scan_ref(a.float(), u.float(), h)[0], h)
        for final in (dhf, None):
            got = rglru_scan_bwd_chunked_ref(a, h_prev, dh, final, chunk)
            ref = rglru_scan_bwd_ref(a, h_prev, dh, final)
            for what, g, r in zip(("da", "du", "dh0"), got, ref):
                tol = BF16_TOL if dtype == torch.bfloat16 and what != "dh0" \
                    else RGLRU_TOL
                _within(f"{what} {(B, S, R, chunk)} dh_final "
                        f"{final is not None} {dtype}", g, r, tol)


def test_chunked_error_against_f64_is_the_oracles():
    """Against an f64 walk of the same f32 inputs, the chunked forward and
    backward err at most 1.1 times as much as the sequential loops, largest
    and mean error, at chunks of 16, 64 and 80 steps over S 2048, with the
    model's decay and the grid's."""
    for model_a in (True, False):
        _f64_case(model_a)


def _f64_case(model_a):
    B, S, R = 2, 2048, 128
    a, u, h, dh, dhf = _inputs(7, B, S, R, True, model_a)
    ad, hd = a.double(), h.double()
    walk, x = torch.empty_like(ad), hd
    for t in range(S):
        x = ad[:, t] * x + u.double()[:, t]
        walk[:, t] = x
    seq = rglru_scan_ref(a, u, h)[0]
    h_prev = _h_prev(seq, h)
    grads = [torch.empty_like(ad), torch.empty_like(ad)]
    x = dhf.double()
    for t in reversed(range(S)):
        g = dh.double()[:, t] + x
        grads[0][:, t], grads[1][:, t] = g * h_prev.double()[:, t], g
        x = ad[:, t] * g
    f64 = [walk, *grads, x]
    oracle = [seq, *rglru_scan_bwd_ref(a, h_prev, dh, dhf)]
    for chunk in (16, 64, 80):
        got = [rglru_scan_chunked_ref(a, u, h, chunk)[0],
               *rglru_scan_bwd_chunked_ref(a, h_prev, dh, dhf, chunk)]
        for what, g, o, w in zip(("h_seq", "da", "du", "dh0"), got, oracle, f64):
            e, e_seq = (g.double() - w).abs(), (o.double() - w).abs()
            assert e.max() <= 1.1 * e_seq.max(), (what, chunk)
            assert e.mean() <= 1.1 * e_seq.mean(), (what, chunk)


def test_forward_mirror_vs_jax_ref():
    """The chunked forward against the JAX package's sequential scan (jnp),
    f32, over the grid."""
    for i, (B, S, R, h0, model_a, chunk) in enumerate(GRID):
        a, u, h, _, _ = _inputs(300 + i, B, S, R, h0, model_a)
        hs, hf = rglru_scan_chunked_ref(a, u, h, chunk)
        ref, ref_final = jax_ref(jnp.asarray(a.numpy()), jnp.asarray(u.numpy()),
                                 None if h is None else jnp.asarray(h.numpy()))
        for got, want in ((hs, ref), (hf, ref_final)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                       rtol=1e-4, atol=1e-4)


def test_cpu_wrappers_return_the_mirrors_bits():
    """On CPU tensors ``rglru_scan_fwd`` and ``rglru_scan_bwd`` compute the
    mirrors with the chunk the kernels would take (``chunk_length``) or the
    one given, f32 and bf16, and launch nothing."""
    before = dict(LAUNCHES)
    for i, (B, S, R, h0, model_a, chunk) in enumerate(GRID):
        for given, dtype in ((None, torch.float32), (chunk, torch.float32),
                             (None, torch.bfloat16), (chunk, torch.bfloat16)):
            a, u, h, dh, dhf = _inputs(400 + i, B, S, R, h0, model_a, dtype)
            c = chunk_length(B, S, R) if given is None else given
            hs, hf, h_state = rglru_scan_fwd(a, u, h, return_state=True,
                                             chunk=given)
            mirror = rglru_scan_chunked_ref(a, u, h, c)
            assert torch.equal(hs, mirror[0]) and torch.equal(hf, mirror[1])
            assert torch.equal(h_state, rglru_scan_chunked_ref(
                a.float(), u.float(), h, c)[0])
            got = rglru_scan_bwd(a, h_state, h, dh, dhf, chunk=given)
            want = rglru_scan_bwd_chunked_ref(a, _h_prev(h_state, h), dh, dhf,
                                              c)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("h0", [True, False])
def test_scan_function_on_cpu_matches_autograd_of_the_sequential_loop(h0):
    """``RGLRUScan`` on CPU tensors (the wrappers' chunked mirrors, 64-step
    chunks at this shape) against autograd through ``rglru_scan_ref``, f32,
    the model's decay over S 2048."""
    B, S, R = 2, 2048, 8
    a, u, h, dh, dhf = _inputs(21, B, S, R, h0, True)
    assert n_chunks(S, chunk_length(B, S, R)) > 1
    grads = []
    for fn in (RGLRUScan.apply, rglru_scan_ref):
        leaves = [t.clone().requires_grad_() if t is not None else None
                  for t in (a, u, h)]
        hs, hf = fn(*leaves)
        grads.append(torch.autograd.grad(
            [hs, hf], [t for t in leaves if t is not None], [dh, dhf]))
    for what, g, r in zip(("da", "du", "dh0"), *grads):
        _within(what, g, r, RGLRU_TOL)


def test_chunk_length_rule():
    """One chunk from FULL_CHAINS chains on (recurrentgemma-2b's serving
    batch 4); below, chunks that are multiples of UNROLL and at least
    MIN_CHUNK steps, 80 at its training batch 1."""
    assert chunk_length(4, 2048, 2560) >= 2048
    assert chunk_length(1, 2048, FULL_CHAINS) >= 2048
    assert chunk_length(1, 2048, 2560) == 80
    assert n_chunks(2048, chunk_length(2, 2048, 2560)) == 13
    for B, S, R in ((1, 2048, 2560), (2, 2048, 2560), (3, 2048, 2560),
                    (1, 37, 5), (2, 300, 100), (1, 10 ** 6, 64)):
        c = chunk_length(B, S, R)
        assert c % UNROLL == 0 and c >= MIN_CHUNK, (B, S, R, c)


def test_wrappers_check_the_chunk_before_launching():
    """Off the CPU a chunk below 1, or more chunks than the grid holds,
    raises before the kernel; meta tensors reach the checks with no card."""
    m = lambda *s: torch.empty(s, device="meta")
    a = m(1, 70000, 4)
    before = dict(LAUNCHES)
    for chunk, error in ((0, "at least 1"), (1, "exceed the kernels' grid")):
        with pytest.raises(ValueError, match=error):
            rglru_scan_fwd(a, a, chunk=chunk)
        with pytest.raises(ValueError, match=error):
            rglru_scan_bwd(a, m(1, 70000, 4), None, a, chunk=chunk)
    assert dict(LAUNCHES) == before
