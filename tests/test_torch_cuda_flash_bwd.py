"""The flash backward's warpgroup kernels (bf16 at head_dim 16 and 64,
``flash_attn_bwd_dkdv_wg_kernel`` and ``flash_attn_bwd_dq_wg_kernel`` of
``csrc/flash_attn_bwd.cu``) on the card.  Every test is marked ``cuda`` and
skips without a card; the file imports neither JAX nor the JAX package:

    python -m pytest -q -m cuda tests/test_torch_cuda_flash_bwd.py

- the warpgroup products as the kernels issue them
  (``flash_attn_bwd_wgmma_probe``: the descriptors of both swizzles, K-major
  and MN-major B, A from registers) against ``torch.matmul`` on the same
  bf16 values, 1e-3 abs + rel (exact products, f32 sums in the tensor
  cores' order);
- D, dq, dk and dv against ``attention_bwd_ref`` from the same inputs
  (2e-2 abs + rel in bf16, D 1e-5; ``tests/test_torch_cuda.py``'s bars) at
  the four training shapes and the physical mode's two;
- two launches on the same inputs give the same bits (no atomics);
- no local memory, the shared bytes of the design and registers for three
  blocks an SM, as ``bwd_attributes`` reports them.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.kernel import (BWD_KERNELS, BWD_SOURCE,
                                                        bwd_attributes,
                                                        bwd_buffers,
                                                        flash_attention_fwd,
                                                        launch_bwd)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

pytestmark = pytest.mark.cuda

BWD_TOL = dict(rtol=2e-2, atol=2e-2)
D_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = {  # (B, S, H, KH, hd, window, causal)
    "qwen3-0.6b": (4, 2048, 16, 8, 64, None, True),
    "granite-moe-3b-a800m": (4, 2048, 24, 8, 64, None, True),
    "whisper-medium decoder": (4, 2048, 16, 16, 64, None, True),
    "whisper-medium encoder": (4, 1500, 16, 16, 64, None, False),
    "physical mode smollm-135m": (2, 32, 9, 3, 64, None, True),
    "physical mode qwen3-0.6b": (2, 32, 16, 8, 64, None, True),
}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _np(x):
    return x.detach().float().cpu().numpy()


def _inputs(device, B, S, H, KH, hd, window, causal, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(device, torch.bfloat16)
                   for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd),
                             (B, S, H, hd)))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    return q, k, v, o, lse, do


def _backward(q, k, v, o, lse, do, window, causal):
    bufs = bwd_buffers(q, k, v, o, lse, do, window=window)
    for name in BWD_KERNELS:
        launch_bwd(name, bufs, causal=causal, window=window)
    torch.cuda.synchronize()
    return bufs


def test_wgmma_products_on_card(cuda_device):
    fn = load(BWD_SOURCE).flash_attn_bwd_wgmma_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    for hd in (16, 64):
        for which in (0, 1):
            x, y = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                    .to(cuda_device, torch.bfloat16)
                    for s in ((64, 64 if which else hd), (64, hd)))
            d = torch.empty(64, hd if which else 64, device=cuda_device)
            stream = torch.cuda.current_stream(cuda_device).cuda_stream
            assert fn(x.data_ptr(), y.data_ptr(), d.data_ptr(), hd, which, stream) == 0
            torch.cuda.synchronize()
            ref = x.float() @ (y.float() if which else y.float().T)
            np.testing.assert_allclose(_np(d), _np(ref), rtol=1e-3, atol=1e-3,
                                       err_msg=f"hd {hd}, product {which}")


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_warpgroup_backward_vs_plain_on_card(cuda_device, shape):
    """One launch of each backward kernel against attention_bwd_ref."""
    B, S, H, KH, hd, window, causal = shape
    q, k, v, o, lse, do = _inputs(cuda_device, *shape, seed=S + H)
    before = {n: LAUNCHES[n] for n in BWD_KERNELS}
    bufs = _backward(q, k, v, o, lse, do, window, causal)
    assert {n: LAUNCHES[n] - before[n] for n in BWD_KERNELS} == dict.fromkeys(BWD_KERNELS, 1)
    np.testing.assert_allclose(
        _np(bufs["delta"]), _np((do.float() * o.float()).sum(-1).transpose(1, 2)), **D_TOL)
    ref = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    for what, r in zip(("dq", "dk", "dv"), ref):
        got = bufs[what]
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(_np(got), _np(r), err_msg=what, **BWD_TOL)


@pytest.mark.parametrize("shape", [(1, 300, 6, 2, 64, 100, True),
                                   (2, 129, 4, 4, 16, None, True)])
def test_warpgroup_backward_bits_equal_across_launches(cuda_device, shape):
    """A ragged windowed GQA case at hd 64 and a ragged hd-16 one: every
    output the same bits from two launches."""
    B, S, H, KH, hd, window, causal = shape
    args = _inputs(cuda_device, *shape, seed=3)
    first = _backward(*args, window, causal)
    second = _backward(*args, window, causal)
    for what in ("dq", "dk", "dv"):
        assert torch.equal(first[what].view(torch.int16), second[what].view(torch.int16)), what


@pytest.mark.parametrize("name,shared", [
    # K and V of 64 keys, three stages of Q and dO (64 x hd bf16 each), L and
    # D of three stages, 1024 bytes of alignment
    ("flash_attn_bwd_dkdv", {16: 1024 + 8 * 64 * 16 * 2 + 3 * 2 * 64 * 4,
                             64: 1024 + 8 * 64 * 64 * 2 + 3 * 2 * 64 * 4}),
    # Q and dO of 64 queries, three stages of K and V
    ("flash_attn_bwd_dq", {16: 1024 + 8 * 64 * 16 * 2, 64: 1024 + 8 * 64 * 64 * 2})])
def test_warpgroup_kernels_use_no_local_memory(cuda_device, name, shared):
    """No local memory, the shared bytes of the design, and at most 168
    registers a thread: three blocks of 128 threads an SM."""
    for hd, nbytes in shared.items():
        attrs = bwd_attributes(name, hd, torch.bfloat16)
        print(f"{name} hd {hd}: {attrs}")
        assert attrs["local_bytes"] == 0 and attrs["shared_bytes"] == nbytes, attrs
        assert 0 < attrs["registers"] <= 168, attrs
