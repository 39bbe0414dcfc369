"""The flash backward's own C++ on the CPU: ``csrc/flash_attn_bwd.cu``
built with g++ against ``tools/cuda_emu/cuda_emu.h``, whose warpgroup
product (wgmma) is applied at the ``wgmma.wait_group`` that retires it, and
called through its ``extern "C"`` entries with CPU tensors:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_bwd_emu.py

- the warpgroup products the bf16 kernels issue at head_dim 16 and 64
  (``flash_attn_bwd_wgmma_probe``: S-like, both operands K-major; dV-like, A
  from registers and B MN-major; the 32- and 128-byte swizzles) against
  ``torch.matmul`` on the same bf16 values (1e-5: exact products, f32 sums
  in another order);
- the bf16 backward at head_dim 16 and 64 (``flash_attn_bwd_pre``, then the
  warpgroup dK/dV and dQ kernels) against ``attention_bwd_ref`` from the same
  q, k, v, o, L and dO, at 2e-2 abs + rel (the card's bar: the outputs and
  P and dS are rounded to bf16), causal and not, ragged S, S 32 (the
  physical mode's shapes), G = 1, 2 and 3 and a window inside a tile; two
  runs give the same bits; and one case against ``jax.grad`` of the reference's
  ``attention_ref`` from the same numpy inputs.
What the emulation cannot show (the card's reading of the descriptors,
speed, registers, spills) ``tests/test_torch_cuda_flash_bwd.py`` and
``chip_smoke.py`` show on the card.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref, lse_ref)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attn_bwd.cu"
V, I = ctypes.c_void_p, ctypes.c_int
TOL = 2e-2


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("flash_bwd_emu") / "libflash_attn_bwd.so"
    proc = subprocess.run([sys.executable, str(ROOT / "tools/cuda_emu/build.py"),
                           str(SRC), str(out)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    built = ctypes.CDLL(str(out))
    built.flash_attn_bwd_wgmma_probe.argtypes = [V] * 3 + [I] * 2 + [V]
    built.flash_attn_bwd_pre.argtypes = [V] * 3 + [I] * 5 + [V]
    built.flash_attn_bwd_dkdv.argtypes = [V] * 10 + [I] * 6 + [
        ctypes.c_float, I, I, I, V]
    built.flash_attn_bwd_dq.argtypes = [V] * 7 + [I] * 6 + [ctypes.c_float, I, I, V]
    return built


def _inputs(seed, B, S, H, KH, hd):
    """q, k, v, dO as f32 numpy arrays of bf16 values."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(torch.bfloat16).float().numpy()
            for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd), (B, S, H, hd))]


def _emulated_bwd(lib, q, k, v, o, lse, do, causal, window):
    """The three entries in launch order: (dq, dk, dv) in bf16."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    delta = torch.empty(B, H, S)
    assert lib.flash_attn_bwd_pre(o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                                  B, S, H, hd, 1, None) == 0
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (B, S, H, KH, hd, 1, 1.0 / hd ** 0.5, int(causal), window or 0)
    assert lib.flash_attn_bwd_dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                   dk.data_ptr(), dv.data_ptr(), None, None,
                                   *common, 1, None) == 0
    assert lib.flash_attn_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                 dq.data_ptr(), *common, None) == 0
    return dq, dk, dv


def _case(lib, seed, B, S, H, KH, hd, window, causal):
    """Inputs in bf16, o and L from the plain forward, the emulated
    gradients and the plain ones."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(seed, B, S, H, KH, hd))
    mask = dict(causal=causal, window=window)
    o = attention_ref(q, k, v, **mask).contiguous()
    lse = lse_ref(q, k, **mask).contiguous()
    got = _emulated_bwd(lib, q, k, v, o, lse, do, causal, window)
    return (q, k, v, do), got, attention_bwd_ref(q, k, v, o, lse, do, **mask)


def _close(what, got, ref, tol=TOL):
    got, ref = got.float().numpy(), ref.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("hd", [16, 64])
def test_emulated_wgmma_vs_matmul(lib, hd, which):
    """which 0: d = x y^T over head_dim (S^T = K Q^T, S = Q K^T); which 1:
    d = x y over 64 rows with x in registers (dV = P^T dO, dK, dQ)."""
    rng = np.random.default_rng(10 * hd + which)
    x = torch.from_numpy(rng.normal(size=(64, 64 if which else hd))
                         .astype(np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.normal(size=(64, hd)).astype(np.float32)).to(torch.bfloat16)
    d = torch.empty(64, hd if which else 64)
    assert lib.flash_attn_bwd_wgmma_probe(x.data_ptr(), y.data_ptr(), d.data_ptr(),
                                          hd, which, None) == 0
    ref = x.float() @ (y.float() if which else y.float().T)
    np.testing.assert_allclose(d.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,KH,hd,window,causal", [
    (2, 129, 4, 4, 16, None, True),    # the reduced configs' head_dim; ragged
    (1, 70, 3, 1, 16, None, False),    # non-causal, G 3
    (1, 200, 4, 2, 64, None, True),    # ragged: the last block holds 8 rows
    (2, 32, 9, 3, 64, None, True),     # the physical mode's shapes, G 3
    (1, 160, 2, 2, 64, 40, True),      # a window inside a tile, G 1
    (1, 150, 2, 1, 64, None, False),   # non-causal, ragged (whisper's encoder)
])
def test_emulated_backward_vs_plain(lib, B, S, H, KH, hd, window, causal):
    _, got, ref = _case(lib, S + hd, B, S, H, KH, hd, window, causal)
    for what, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16
        _close(what, g, r)


def test_emulated_backward_bits_equal_across_runs(lib):
    """Every output is written once by one thread: no atomics, the same
    bits from two runs on the same inputs (also at S 32, one partial tile)."""
    for shape in ((1, 96, 6, 2, 64, None, True), (2, 32, 16, 8, 64, None, True)):
        (q, k, v, do), first, _ = _case(lib, 5, *shape)
        o = attention_ref(q, k, v).contiguous()
        lse = lse_ref(q, k).contiguous()
        a = _emulated_bwd(lib, q, k, v, o, lse, do, True, None)
        b = _emulated_bwd(lib, q, k, v, o, lse, do, True, None)
        for x, y, z in zip(a, b, first):
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))
            assert torch.equal(x.view(torch.int16), z.view(torch.int16))


def test_emulated_backward_vs_jax_grad(lib):
    """The emulated kernels' gradients against jax.grad of the reference's
    attention_ref, from the same numpy values (GQA, causal, ragged)."""
    B, S, H, KH, hd = 1, 100, 4, 2, 64
    qn, kn, vn, don = _inputs(17, B, S, H, KH, hd)
    ref = jax.grad(lambda q, k, v: jnp.sum(
        jax_ref(q, k, v, causal=True) * don), argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in (qn, kn, vn, don))
    o = attention_ref(q, k, v).contiguous()
    got = _emulated_bwd(lib, q, k, v, o, lse_ref(q, k).contiguous(), do, True, None)
    for what, g, r in zip(("dq", "dk", "dv"), got, ref):
        _close(what, g, torch.from_numpy(np.array(r)))
