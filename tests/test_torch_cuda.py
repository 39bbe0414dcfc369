"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here is marked ``cuda`` and skips without a card; the
file imports neither JAX nor the JAX package, so it runs where JAX is not
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 and bf16 2e-2 for the attention kernel
(``tests/test_kernels.py``); 2e-4 for the SSD kernel in either input type
(both sides compute in f32 from the same inputs and write f32: the f32 bound
of ``tests/test_kernels.py``); for the RG-LRU scan 1e-5 on its f32 outputs
(the kernel takes the plain version's f32 products and sums in the same
order with the same rounding, so they should agree exactly) and one bf16
step, 8e-3, on h_seq from bf16 inputs; 1e-4 for f32 model logits through a
few layers, where only the order of sums differs between the card and the
CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, attributes
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd_scan.kernel import ssd_chunk
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import chunk_cumsum, ssd_chunk_ref
from repro_torch.models.lm import LM, init_params
from repro_torch.models.steps import make_decode_step, make_prefill_step

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SHAPES = [  # (B, S, H, KH, hd, window, causal)
    (1, 128, 2, 2, 64, None, True),     # tests/test_kernels.py's grid
    (2, 256, 4, 2, 64, None, True),
    (1, 256, 4, 1, 128, None, True),
    (2, 256, 4, 2, 64, 64, True),
    (1, 512, 2, 2, 64, 128, True),
    (2, 200, 4, 2, 64, None, True),     # ragged lengths
    (1, 1000, 4, 2, 64, 96, True),
    (1, 5, 2, 1, 64, None, True),
    (1, 300, 4, 2, 128, None, False),   # non-causal
    (2, 64, 4, 4, 16, None, True),      # the reduced configs' head_dim
    (1, 100, 2, 1, 16, 16, True),
    (1, 128, 4, 1, 256, None, True),    # recurrentgemma-2b's head_dim
    (1, 300, 10, 1, 256, 128, True),    # ragged, windowed
    (1, 4096, 10, 1, 256, 2048, True),  # the window bites at its width
    (2, 100, 4, 2, 256, None, False),   # non-causal
    (1, 5, 2, 1, 256, None, True),
    # the bf16 kernel's tile edges (query x key tiles: 128 x 64 at hd 64
    # and 256, 64 x 64 at hd 16 and 128): S = 1, 15, 63, 65, 127,
    # 129, 2049; window 1; windows starting inside a key tile; KH = H, KH = 1
    (1, 1, 2, 1, 64, None, True),
    (2, 15, 4, 4, 64, None, True),
    (1, 63, 4, 1, 64, None, True),
    (1, 65, 2, 2, 64, None, False),
    (1, 127, 4, 2, 64, 1, True),
    (2, 129, 4, 2, 64, 40, True),
    (1, 2049, 4, 2, 64, None, True),
    (1, 2049, 2, 1, 64, 300, True),
    (2, 129, 4, 4, 16, None, True),
    (1, 65, 2, 1, 16, 1, True),
    (1, 129, 4, 2, 128, 40, True),
    (1, 63, 2, 2, 128, None, False),
    (1, 1, 2, 1, 256, None, True),
    (1, 15, 2, 2, 256, None, True),
    (1, 63, 10, 1, 256, None, True),
    (1, 65, 4, 1, 256, 1, True),
    (1, 127, 4, 2, 256, 40, True),
    (1, 129, 2, 1, 256, None, False),
    (1, 2049, 10, 1, 256, 2048, True),
]


SSD_SHAPES = [  # (Bt, S, H, P, G, N, chunk, model A): tests/test_kernels.py's grid
    (1, 64, 2, 16, 1, 32, 16, False),
    (2, 128, 4, 16, 2, 32, 32, False),
    (1, 96, 2, 32, 1, 16, 32, False),
    (2, 48, 8, 16, 1, 16, 8, False),        # the reduced config's (P, N, chunk)
    (1, 512, 4, 64, 1, 128, 256, True),     # mamba2-780m's (P, N, chunk), its A
    (4, 2048, 48, 64, 1, 128, 256, False),  # mamba2-780m's serving shape
    (4, 2048, 48, 64, 1, 128, 256, True),
]
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
RGLRU_SHAPES = [  # (B, S, R, h0, model a)
    (1, 64, 64, True, False),           # tests/test_kernels.py's grid
    (2, 128, 128, True, False),
    (2, 96, 192, True, False),
    (2, 300, 100, True, False),         # ragged S and R
    (1, 37, 5, False, False),           # h0 None
    (4, 2048, 2560, False, True),       # recurrentgemma-2b's serving shape
]
RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np(x):
    return x.detach().float().cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,window,causal", SHAPES)
def test_kernel_vs_plain_on_card(cuda_device, B, S, H, KH, hd, window, causal,
                                 dtype):
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)))
    before = LAUNCHES["flash_attn_fwd"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attn_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bf16_kernel_uses_no_local_memory(cuda_device, hd):
    """The tensor-core kernel at every head_dim neither spills nor keeps a
    stack: its compiled local memory is 0 bytes."""
    attrs = attributes(hd, torch.bfloat16)
    assert attrs["local_bytes"] == 0, attrs


def _ssd_inputs(device, dtype, Bt, S, H, P, G, N, model_a, seed):
    """Drawn as tests/test_kernels.py draws them; with ``model_a`` the
    model's A = -linspace(1, 16, H), which takes cum to large negative
    values within a chunk."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    A = -np.linspace(1.0, 16.0, H) if model_a else -rng.uniform(0.5, 2.0, H)
    return (f(rng.normal(size=(Bt, S, H, P))).to(dtype),
            f(rng.uniform(0.1, 0.9, size=(Bt, S, H))), f(A),
            f(rng.normal(size=(Bt, S, G, N))).to(dtype),
            f(rng.normal(size=(Bt, S, G, N))).to(dtype),
            f(rng.normal(size=(H,))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,model_a", SSD_SHAPES)
def test_ssd_kernel_vs_plain_on_card(cuda_device, Bt, S, H, P, G, N, chunk,
                                     model_a, dtype):
    x, dt, A, B, C, _ = _ssd_inputs(cuda_device, dtype, Bt, S, H, P, G, N,
                                    model_a, seed=S + H)
    cum = chunk_cumsum(dt, A, chunk)
    before = LAUNCHES["ssd_chunk"]
    y, cin = ssd_chunk(x, dt, cum, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_chunk"] == before + 1
    y_ref, cin_ref = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    for got, ref in ((y, y_ref), (cin, cin_ref)):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(_np(got), _np(ref), **SSD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_padded_through_the_kernel_on_card(cuda_device, dtype):
    """S = 80 with chunk 32: ops.ssd pads to 96 and launches the kernel once."""
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, dtype, 1, 80, 2, 16, 1, 16,
                                    False, seed=80)
    before = LAUNCHES["ssd_chunk"]
    y, h = ssd(x, dt, A, B, C, D, chunk=32)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_chunk"] == before + 1
    y_ref, h_ref = ssd(x, dt, A, B, C, D, chunk=32, impl="reference")
    # both round y to x's dtype once; the f32 values differ only in the order
    # of sums, so y may differ by one step of its type
    tol = SSD_TOL if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(_np(y), _np(y_ref), **tol)
    np.testing.assert_allclose(_np(h), _np(h_ref), **SSD_TOL)


def _rglru_inputs(device, dtype, B, S, R, h0, model_a, seed):
    """a in [0.5, 0.999) as tests/test_kernels.py draws it, or the model's
    a = exp(-8 softplus(1) sigmoid(z)), about 3e-5 to 1, with its gated
    u = sqrt(1 - a^2) N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    if model_a:
        a = np.exp(-8 * np.log1p(np.e) / (1 + np.exp(-rng.normal(size=(B, S, R)))))
        u = np.sqrt(1 - a * a) * rng.normal(size=(B, S, R))
    else:
        a = rng.uniform(0.5, 0.999, size=(B, S, R))
        u = rng.normal(size=(B, S, R))
    return (f(a).to(dtype), f(u).to(dtype),
            f(rng.normal(size=(B, R))) if h0 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R,h0,model_a", RGLRU_SHAPES)
def test_rglru_kernel_vs_plain_on_card(cuda_device, B, S, R, h0, model_a, dtype):
    a, u, h = _rglru_inputs(cuda_device, dtype, B, S, R, h0, model_a, seed=S + R)
    before = LAUNCHES["rglru_scan"]
    hs, h_final = rglru_scan(a, u, h)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 1
    hs_ref, final_ref = rglru_scan_ref(a, u, h)
    assert hs.dtype == dtype and h_final.dtype == torch.float32
    assert bool(torch.isfinite(hs).all()) and bool(torch.isfinite(h_final).all())
    tol = RGLRU_TOL if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(_np(hs), _np(hs_ref), **tol)
    np.testing.assert_allclose(_np(h_final), _np(final_ref), **RGLRU_TOL)


# Kernel launches per prefill of each reduced config: one per attention or
# SSM or RG-LRU layer of its kind.
REDUCED_LAUNCHES = {
    "qwen3-0.6b": {"flash_attn_fwd": 2},
    "smollm-135m": {"flash_attn_fwd": 2},
    "mamba2-780m": {"ssd_chunk": 2},
    "recurrentgemma-2b": {"flash_attn_fwd": 1, "rglru_scan": 4},
}


@pytest.mark.parametrize("arch", sorted(REDUCED_LAUNCHES))
def test_reduced_model_on_card_matches_cpu(cuda_device, arch):
    """Prefill (through the kernels of the arch's blocks) and 4 greedy decode
    steps on the card against the same weights on the CPU."""
    cfg = ARCHS[arch].reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    gpu = LM(cfg, {k: t.to(cuda_device) for k, t in cpu.state_dict().items()})
    B, S, new = 2, 40, 4
    prompts = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, size=(B, S)))
    prefill = make_prefill_step(cfg, cache_len=S + new)
    decode = make_decode_step(cfg)
    with torch.inference_mode():
        LAUNCHES.clear()
        glog, gcache = prefill(gpu, {"tokens": prompts.to(cuda_device)})
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == REDUCED_LAUNCHES[arch]
        clog, ccache = prefill(cpu, {"tokens": prompts})
        np.testing.assert_allclose(_np(glog), _np(clog), rtol=1e-4, atol=1e-4)
        for i in range(new):
            ctok = clog[:, -1].argmax(-1)[:, None]
            assert torch.equal(glog[:, -1].argmax(-1)[:, None].cpu(), ctok)
            glog, gcache = decode(gpu, gcache, ctok.to(cuda_device), S + i)
            clog, ccache = decode(cpu, ccache, ctok, S + i)
            np.testing.assert_allclose(_np(glog), _np(clog), rtol=1e-4, atol=1e-4)
