"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here is marked ``cuda`` and skips without a card; the
file imports neither JAX nor the JAX package, so it runs where JAX is not
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 and bf16 2e-2 for the attention kernel
(``tests/test_kernels.py``); 2e-4 for the f32 path's SSD kernel in either
input type (both sides compute in f32 from the same inputs and write f32: the
f32 bound of ``tests/test_kernels.py``); for the bf16 SSD path's kernels the
cumsum to the bit, chunk states and final state 2e-4, y one bf16 step, 8e-3
(both sides round y to bf16 once; the tensor cores take the f32 operands as
hi + lo bf16 pairs, ``csrc/ssd_bf16.cu``); for the RG-LRU scan the bits of its chunked
mirror (``rglru_scan_chunked_ref``: the same rounded f32 products and sums
in the same order), and against the sequential oracle 1e-5 on its f32
outputs (the order of f32 operations differs where chunks meet) and one
bf16 step, 8e-3, on h_seq from bf16 inputs; 1e-4 for f32 model logits through a
few layers, where only the order of sums differs between the card and the
CPU.  The flash backward's kernels against ``attention_bwd_ref`` from the
same inputs: 1e-4 on f32 gradients (sums of up to S or G·S terms in another
order), 2e-2 on bf16 ones (one rounding of each output, and of P and dS
where a kernel rounds them for its products), 1e-5 on D and on the
forward's log-sum-exp against ``lse_ref``.  The RG-LRU backward the same way against
``rglru_scan_bwd_chunked_ref`` (the bits) and ``rglru_scan_bwd_ref`` (1e-5 in
f32, one bf16 step, 8e-3, on bf16 da and du).  The SSD backward's
kernels against their plain versions from the same inputs: 1e-4 in f32 and
2e-2 in bf16 inputs, taken relative to each gradient's largest magnitude for
the gradients that sum over a chunk's rows (all but dchunk_in and dh0, which
come from an elementwise recurrence over the chunks).  The packing pass
(``kernels/pack_fill``) against ``pack_all_types_ref`` on CPU copies of the
same inputs: its records, counts and budget equal.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.cluster.localcloud import LocalCloud, LocalJob
from repro_torch.configs import ARCHS
from repro_torch.core import Catalog, EvaScheduler
from repro_torch.core.catalog import InstanceType
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.kernel import (BWD_KERNELS, HEAD_DIMS,
                                                        attributes,
                                                        bwd_attributes,
                                                        bwd_buffers, bwd_splits,
                                                        flash_attention_bwd,
                                                        flash_attention_fwd,
                                                        launch_bwd)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.pack_fill.kernel import PER_LANE, pack_fill
from repro_torch.kernels.pack_fill.ref import pack_all_types_ref
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref, lse_ref)
from repro_torch.kernels.rglru_scan.kernel import (chunk_length, cuda_launches,
                                                   n_chunks, rglru_scan_bwd,
                                                   rglru_scan_fwd)
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_chunked_ref,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_chunked_ref,
                                                rglru_scan_ref)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.kernel import (ssd_bwd_chunk, ssd_bwd_dstate,
                                                 ssd_bwd_state_pass, ssd_chunk)
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import (chunk_bwd_ref, chunk_cumsum,
                                              chunk_dstate_ref, chunk_scan_ref,
                                              chunk_state_ref, pass_states,
                                              ssd_chunk_ref, ssd_chunked_ref,
                                              state_pass_bwd_ref)
from repro_torch.models import ssm
from repro_torch.models.lm import LM, init_params
from repro_torch.models.params import flatten, unflatten
from repro_torch.models.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.train.optimizer import init_opt_state

from torch_pack_cases import PACK_CASES, pack_case

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
# The bf16 path also at G = 3, and chunks that are not a multiple of its
# kernels' 16-row tiles
SSD_BF16_SHAPES = SSD_SHAPES + [
    (1, 96, 4, 16, 2, 32, 24, True),
    (2, 64, 6, 32, 3, 16, 16, True),
    (1, 40, 2, 16, 1, 16, 5, True),
]
BF16_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
RGLRU_SHAPES = [  # (B, S, R, h0, model a)
    (1, 64, 64, True, False),           # tests/test_kernels.py's grid
    (2, 128, 128, True, False),
    (2, 96, 192, True, False),
    (2, 300, 100, True, False),         # ragged S and R
    (1, 37, 5, False, False),           # h0 None
    (4, 2048, 2560, False, True),       # recurrentgemma-2b's serving shape
]
# ... each in the wrapper's chunks (chunk None: kernel.chunk_length), and
# chunks given: S 37 in chunks of 16, S 300 in chunks of 64 (neither divides S)
RGLRU_CASES = [pytest.param(*shape, None, id="-".join(map(str, shape)))
               for shape in RGLRU_SHAPES] + [
    pytest.param(2, 37, 70, True, False, 16, id="2-37-70-True-False-chunk16"),
    pytest.param(2, 300, 100, False, False, 64, id="2-300-100-False-False-chunk64"),
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
    LAUNCHES.clear()
    y, h = ssd(x, dt, A, B, C, D, chunk=32)
    torch.cuda.synchronize()
    # f32 takes the CUDA-core kernel, bf16 the tensor-core path
    assert dict(LAUNCHES) == ({"ssd_chunk": 1} if dtype == torch.float32
                              else dict.fromkeys(BF16_KERNELS, 1))
    y_ref, h_ref = ssd(x, dt, A, B, C, D, chunk=32, impl="reference")
    # both round y to x's dtype once; the f32 values differ only in the order
    # of sums, so y may differ by one step of its type
    tol = SSD_TOL if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(_np(y), _np(y_ref), **tol)
    np.testing.assert_allclose(_np(h), _np(h_ref), **SSD_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,model_a", SSD_BF16_SHAPES)
def test_ssd_bf16_path_vs_plain_on_card(cuda_device, Bt, S, H, P, G, N, chunk,
                                        model_a, with_h0):
    """Each kernel of the bf16 path against its plain version from the same
    inputs, then the whole ``ops.ssd`` against ``ssd_chunked_ref`` with one
    launch of each kernel."""
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, torch.bfloat16, Bt, S, H, P,
                                    G, N, model_a, seed=S + H + 1)
    h0 = torch.from_numpy(np.random.default_rng(7).normal(
        size=(Bt, H, P, N)).astype(np.float32)).to(cuda_device) if with_h0 else None
    cum = chunk_cumsum(dt, A, chunk)
    cin, cum_k = ssd_kernel.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    assert torch.equal(cum_k, cum)  # PyTorch's order and roundings
    np.testing.assert_allclose(_np(cin), _np(chunk_state_ref(x, dt, cum, B, chunk=chunk)),
                               **SSD_TOL)
    h_ins, h_final = ssd_kernel.ssd_state_pass(cin, cum, h0, chunk=chunk)
    ref_ins, ref_final = pass_states(cin, torch.exp(cum[:, chunk - 1::chunk]), h0)
    np.testing.assert_allclose(_np(h_ins), _np(ref_ins), **SSD_TOL)
    np.testing.assert_allclose(_np(h_final), _np(ref_final), **SSD_TOL)
    y = ssd_kernel.ssd_chunk_scan(x, dt, cum, B, C, D, h_ins, chunk=chunk)
    y_ref = chunk_scan_ref(x, dt, cum, B, C, D, h_ins, chunk=chunk)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=8e-3, atol=8e-3)

    LAUNCHES.clear()
    y, h = ssd(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == dict.fromkeys(BF16_KERNELS, 1)
    y_ref, h_ref = ssd(x, dt, A, B, C, D, chunk=chunk, h0=h0, impl="reference")
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(_np(h), _np(h_ref), **SSD_TOL)


@pytest.mark.parametrize("P,N", ssd_kernel.PN_PAIRS)
@pytest.mark.parametrize("name", ["ssd_chunk_state", "ssd_chunk_scan"])
def test_ssd_bf16_kernels_use_no_local_memory(cuda_device, name, P, N):
    attrs = ssd_kernel.attributes(name, P, N)
    assert attrs["local_bytes"] == 0, attrs


def test_reduced_mamba2_in_bf16_runs_the_tensor_core_path(cuda_device):
    """A reduced mamba2-780m in bf16 compute prefills through the bf16 path,
    one launch of each kernel a layer, and each layer's SSD output is within
    one bf16 step of the plain path's from the same inputs."""
    import dataclasses
    cfg = dataclasses.replace(ARCHS["mamba2-780m"].reduced(),
                              compute_dtype="bfloat16")
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    model = LM(cfg, {k: t.to(cuda_device) for k, t in cpu.state_dict().items()})
    prompts = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 40)))
    plain_ssd, calls = ssm.ssd, []

    def both(x, dt, A, B, C, D, *, chunk, impl):
        y_ref, h_ref = plain_ssd(x, dt, A, B, C, D, chunk=chunk, impl="reference")
        y, h = plain_ssd(x, dt, A, B, C, D, chunk=chunk, impl=impl)
        assert x.dtype == y.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(y), _np(y_ref), rtol=8e-3, atol=8e-3)
        np.testing.assert_allclose(_np(h), _np(h_ref), **SSD_TOL)
        calls.append(x.shape)
        return y, h

    ssm.ssd = both
    try:
        with torch.inference_mode():
            LAUNCHES.clear()
            logits, _ = make_prefill_step(cfg, cache_len=44)(
                model, {"tokens": prompts.to(cuda_device)})
            torch.cuda.synchronize()
    finally:
        ssm.ssd = plain_ssd
    assert len(calls) == cfg.n_layers
    assert dict(LAUNCHES) == dict.fromkeys(BF16_KERNELS, cfg.n_layers)
    assert bool(torch.isfinite(logits).all())


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
@pytest.mark.parametrize("B,S,R,h0,model_a,chunk", RGLRU_CASES)
def test_rglru_kernel_vs_plain_on_card(cuda_device, B, S, R, h0, model_a, chunk,
                                       dtype):
    """The scan (one launch of the wrapper; two CUDA launches in more than one
    chunk, else one) against the chunked mirror with the same chunk, to the
    bit, and the sequential oracle within RGLRU_TOL."""
    a, u, h = _rglru_inputs(cuda_device, dtype, B, S, R, h0, model_a, seed=S + R)
    before, cuda_before = LAUNCHES["rglru_scan"], cuda_launches()
    hs, h_final = rglru_scan(a, u, h) if chunk is None \
        else rglru_scan_fwd(a, u, h, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 1
    C = n_chunks(S, chunk or chunk_length(B, S, R))
    assert cuda_launches() == cuda_before + (2 if C > 1 else 1)
    mirror = rglru_scan_chunked_ref(a, u, h, chunk or chunk_length(B, S, R))
    assert torch.equal(hs, mirror[0]) and torch.equal(h_final, mirror[1])
    hs_ref, final_ref = rglru_scan_ref(a, u, h)
    assert hs.dtype == dtype and h_final.dtype == torch.float32
    assert bool(torch.isfinite(hs).all()) and bool(torch.isfinite(h_final).all())
    tol = RGLRU_TOL if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(_np(hs), _np(hs_ref), **tol)
    np.testing.assert_allclose(_np(h_final), _np(final_ref), **RGLRU_TOL)


# Kernel launches per prefill of each reduced config: one per attention or
# SSM or RG-LRU layer of its kind (whisper-medium: 2 encoder and 2 decoder
# self-attention layers; its cross-attention is the plain version).
REDUCED_LAUNCHES = {
    "qwen3-0.6b": {"flash_attn_fwd": 2},
    "smollm-135m": {"flash_attn_fwd": 2},
    "mamba2-780m": {"ssd_chunk": 2},
    "recurrentgemma-2b": {"flash_attn_fwd": 1, "rglru_scan": 4},
    "granite-moe-3b-a800m": {"flash_attn_fwd": 2},
    "whisper-medium": {"flash_attn_fwd": 4},
}


def _frames(cfg, batch: int, device):
    """Random encoder frames for an encoder-decoder config, else nothing."""
    if not cfg.enc_dec:
        return {}
    g = torch.Generator().manual_seed(6)
    return {"enc_embeds": torch.randn(batch, cfg.enc_seq, cfg.d_model,
                                      generator=g).to(device)}


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
    frames = _frames(cfg, B, "cpu")
    with torch.inference_mode():
        LAUNCHES.clear()
        glog, gcache = prefill(gpu, {"tokens": prompts.to(cuda_device),
                                     **{k: t.to(cuda_device)
                                        for k, t in frames.items()}})
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == REDUCED_LAUNCHES[arch]
        clog, ccache = prefill(cpu, {"tokens": prompts, **frames})
        np.testing.assert_allclose(_np(glog), _np(clog), rtol=1e-4, atol=1e-4)
        for i in range(new):
            ctok = clog[:, -1].argmax(-1)[:, None]
            assert torch.equal(glog[:, -1].argmax(-1)[:, None].cpu(), ctok)
            glog, gcache = decode(gpu, gcache, ctok.to(cuda_device), S + i)
            clog, ccache = decode(cpu, ccache, ctok, S + i)
            np.testing.assert_allclose(_np(glog), _np(clog), rtol=1e-4, atol=1e-4)


BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_SHAPE = (4, 2048, 16, 8, 64, None, True)  # qwen3-0.6b training


def _qkv_do(device, dtype, B, S, H, KH, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
            for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd), (B, S, H, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,window,causal", SHAPES + [TRAIN_SHAPE])
def test_flash_backward_vs_plain_on_card(cuda_device, B, S, H, KH, hd, window,
                                         causal, dtype):
    """The forward's log-sum-exp against lse_ref, then each backward kernel
    (one launch each) against its plain version from the same inputs."""
    q, k, v, do = _qkv_do(cuda_device, dtype, B, S, H, KH, hd, seed=S + hd + 1)
    mask = dict(causal=causal, window=window)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, **mask)
    torch.testing.assert_close(o, flash_attention_fwd(q, k, v, **mask),
                               rtol=0, atol=0)  # L changes nothing of o
    np.testing.assert_allclose(_np(lse), _np(lse_ref(q, k, **mask)), **LSE_TOL)
    bufs = bwd_buffers(q, k, v, o, lse, do, window=window)
    before = {n: LAUNCHES[n] for n in BWD_KERNELS}
    for name in BWD_KERNELS:
        launch_bwd(name, bufs, **mask)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] - before[n] for n in BWD_KERNELS} == dict.fromkeys(BWD_KERNELS, 1)
    np.testing.assert_allclose(
        _np(bufs["delta"]), _np((do.float() * o.float()).sum(-1).transpose(1, 2)),
        **LSE_TOL)
    ref = attention_bwd_ref(q, k, v, o, lse, do, **mask)
    for got, r in zip((bufs["dq"], bufs["dk"], bufs["dv"]), ref):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(_np(got), _np(r), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,window,causal", [
    (2, 200, 4, 2, 64, None, True), (1, 129, 4, 2, 16, 40, True),
    (1, 100, 4, 4, 64, None, False), (1, 300, 10, 1, 256, 128, True)])
def test_flash_attention_function_vs_autograd_on_card(cuda_device, B, S, H, KH,
                                                      hd, window, causal, dtype):
    """Through ``flash_attention`` with grad on: one forward launch and one
    of each backward kernel, gradients against autograd through
    attention_ref (which also differs in the bf16 kernel's rounding of P
    in the output that D reads: within the bf16 tolerance)."""
    q, k, v, do = _qkv_do(cuda_device, dtype, B, S, H, KH, hd, seed=S + 7)
    mask = dict(causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    LAUNCHES.clear()
    got = torch.autograd.grad(flash_attention(*leaves, **mask), leaves, do)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attn_fwd": 1, **dict.fromkeys(BWD_KERNELS, 1)}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(attention_ref(*leaves, **mask), leaves, do)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        np.testing.assert_allclose(_np(g), _np(r), **BWD_TOL[dtype])


def test_backward_wrapper_checks_on_card(cuda_device):
    """Wrong shapes, types and alignment raise before any launch."""
    q, k, v, do = _qkv_do(cuda_device, torch.float32, 1, 8, 2, 2, 64, seed=1)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True)
    raw = torch.empty(q.numel() + 1, device=cuda_device)
    shifted = raw[1:].view(q.shape)  # contiguous, 4 bytes off 16
    cases = [((q, k, v, o[:, :4].contiguous(), lse, do), "o .* must match q"),
             ((q, k, v, o, lse.to(torch.bfloat16), do), "lse"),
             ((q, k, v, o, lse, do.to(torch.bfloat16)), "do .* must match q"),
             ((q, k, v, o, lse, do.cpu()), "one CUDA device"),
             ((q, k, v, o, lse, do.transpose(1, 2).contiguous().transpose(1, 2)),
              "contiguous"),
             ((q, k, v, o, lse, shifted), "16-byte aligned")]
    before = {n: LAUNCHES[n] for n in BWD_KERNELS}
    for args, error in cases:
        with pytest.raises((ValueError, TypeError), match=error):
            flash_attention_bwd(*args)
    assert {n: LAUNCHES[n] for n in BWD_KERNELS} == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("name", BWD_KERNELS)
def test_flash_backward_kernels_use_no_local_memory(cuda_device, name, hd, dtype):
    attrs = bwd_attributes(name, hd, dtype)
    assert attrs["local_bytes"] == 0, attrs


# recurrentgemma-2b's attention (H 10, KH 1, head_dim 256, window 2048) at
# the training batch 1 and at 4, a ragged S, a window that bites and KH > 1.
WIDE_SHAPES = [  # (B, S, H, KH, window)
    (1, 2048, 10, 1, 2048),
    (4, 2048, 10, 1, 2048),
    (1, 2049, 10, 1, 2048),
    (1, 1000, 10, 1, 300),
    (2, 200, 4, 2, None),
]


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("B,S,H,KH,window", WIDE_SHAPES)
def test_flash_backward_hd256_splits_on_card(cuda_device, B, S, H, KH, window,
                                             splits):
    """The bf16 head_dim-256 backward (the eight-warp tensor-core kernels)
    against attention_bwd_ref, with dK/dV cut into the parts bwd_splits
    picks (None), unsplit, and 3 parts."""
    dtype = torch.bfloat16
    q, k, v, do = _qkv_do(cuda_device, dtype, B, S, H, KH, 256, seed=S + B)
    o, lse = flash_attention_fwd(q, k, v, window=window, return_lse=True)
    bufs = bwd_buffers(q, k, v, o, lse, do, window=window, splits=splits)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert bufs["splits"] == (splits or bwd_splits(B, S, H, KH, 256, dtype, sms))
    for name in BWD_KERNELS:
        launch_bwd(name, bufs, causal=True, window=window)
    torch.cuda.synchronize()
    ref = attention_bwd_ref(q, k, v, o, lse, do, window=window)
    for got, r in zip((bufs["dq"], bufs["dk"], bufs["dv"]), ref):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(_np(got), _np(r), **BWD_TOL[dtype])


@pytest.mark.parametrize("name,shared", [
    # 6 tiles of 64 x 256 bf16, the P and dS tiles (64 x 64 bf16), L and D
    # in two stages
    ("flash_attn_bwd_dkdv", 6 * 64 * 256 * 2 + 2 * 64 * 64 * 2 + 2 * 2 * 64 * 4),
    ("flash_attn_bwd_dq", 6 * 64 * 256 * 2 + 64 * 64 * 2)])
def test_flash_backward_hd256_reports_the_tensor_core_kernels(cuda_device, name,
                                                              shared):
    """bf16 at head_dim 256 launches the eight-warp tensor-core kernels:
    their shared memory, no local memory."""
    attrs = bwd_attributes(name, 256, torch.bfloat16)
    assert attrs["shared_bytes"] == shared and attrs["local_bytes"] == 0, attrs


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "smollm-135m"])
def test_reduced_train_step_on_card_matches_cpu(cuda_device, arch):
    """One train step of a reduced config on the card: each of its 2 layers
    launches the forward kernel twice (the forward and the rematerialised
    recompute) and each backward kernel once; loss, grad_norm and the
    updated parameters as on the CPU from the same weights and batch."""
    cfg = ARCHS[arch].reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0)).tree()
    gpu = unflatten({k: t.to(cuda_device) for k, t in flatten(cpu).items()})
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    step = make_train_step(cfg)
    LAUNCHES.clear()
    gstate, gm = step({"params": gpu, "opt": init_opt_state(gpu)},
                      {k: t.to(cuda_device) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"flash_attn_fwd": 2 * cfg.n_layers,
                              **dict.fromkeys(BWD_KERNELS, cfg.n_layers)}
    cstate, cm = step({"params": cpu, "opt": init_opt_state(cpu)}, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(gm[key]), _np(cm[key]), rtol=1e-5, atol=1e-5)
    # a gradient element below the f32 noise may flip the sign of its Adam
    # update, at most 2 lr(1) = 6e-6 either way (tests/test_torch_train.py)
    g, c = flatten(gstate["params"]), flatten(cstate["params"])
    for key in c:
        np.testing.assert_allclose(_np(g[key]), _np(c[key]), rtol=0, atol=1.2e-5,
                                   err_msg=key)


@pytest.mark.parametrize("dhf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R,h0,model_a,chunk", RGLRU_CASES)
def test_rglru_bwd_kernel_vs_plain_on_card(cuda_device, B, S, R, h0, model_a,
                                           chunk, dtype, dhf):
    """rglru_scan_bwd (one launch) against rglru_scan_bwd_chunked_ref with
    the same chunk, to the bit, and rglru_scan_bwd_ref within RGLRU_TOL, from
    the same a, f32 states, h0, dh_seq and dh_final."""
    a, u, h = _rglru_inputs(cuda_device, dtype, B, S, R, h0, model_a, seed=S * R)
    rng = np.random.default_rng(S)
    dh = torch.from_numpy(rng.normal(size=(B, S, R)).astype(np.float32)).to(
        cuda_device, dtype)
    dh_final = torch.from_numpy(rng.normal(size=(B, R)).astype(np.float32)).to(
        cuda_device) if dhf else None
    _, _, h_state = rglru_scan_fwd(a, u, h, return_state=True, chunk=chunk)
    before = LAUNCHES["rglru_scan_bwd"]
    got = rglru_scan_bwd(a, h_state, h, dh, dh_final, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan_bwd"] == before + 1
    first = torch.zeros_like(h_state[:, :1]) if h is None else h[:, None]
    h_prev = torch.cat([first, h_state[:, :-1]], 1)
    ref = rglru_scan_bwd_ref(a, h_prev, dh, dh_final)
    mirror = rglru_scan_bwd_chunked_ref(a, h_prev, dh, dh_final,
                                        chunk or chunk_length(B, S, R))
    for i, (g, r, m) in enumerate(zip(got, ref, mirror)):
        assert g.dtype == r.dtype and bool(torch.isfinite(g).all())
        assert torch.equal(g, m)
        tol = dict(rtol=8e-3, atol=8e-3) if dtype == torch.bfloat16 and i < 2 \
            else RGLRU_TOL
        np.testing.assert_allclose(_np(g), _np(r), **tol)


SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_BWD_ELEMENTWISE = ("dchunk_in", "dh0")


def _ssd_bwd_close(what, got, ref, dtype, scale=None):
    """abs + rel, relative to the largest |ref| (or to ``scale``: dA's, the
    sum of its terms' magnitudes, ``chunk_bwd_ref``'s dA_scale), elementwise
    for SSD_BWD_ELEMENTWISE."""
    tol = SSD_BWD_TOL[dtype]
    got, ref = _np(got), _np(ref)
    if scale is None:
        scale = np.abs(ref) if what in SSD_BWD_ELEMENTWISE else np.abs(ref).max()
    else:
        scale = _np(scale)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    assert (np.abs(got - ref) - tol - tol * scale).max() <= 0, what


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,model_a", SSD_BF16_SHAPES)
def test_ssd_bwd_kernels_vs_plain_on_card(cuda_device, Bt, S, H, P, G, N, chunk,
                                          model_a, dtype, with_h0):
    """ssd_bwd_dstate, ssd_bwd_state_pass and ssd_bwd_chunk (one launch
    each) against their plain versions from the same inputs, dh_final given
    with h0 and not without."""
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, dtype, Bt, S, H, P, G, N,
                                    model_a, seed=S + H + 1)
    rng = np.random.default_rng(S + N)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda_device)
    h0 = f(Bt, H, P, N) if with_h0 else None
    dhf = f(Bt, H, P, N) if with_h0 else None
    dy = f(Bt, S, H, P).to(dtype)
    cum = chunk_cumsum(dt, A, chunk)
    _, chunk_in = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    h_ins, _ = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]), h0)
    before = dict(LAUNCHES)
    dS = ssd_bwd_dstate(dy, cum, C, chunk=chunk)
    dchunk_in, dh0, end = ssd_bwd_state_pass(dS, cum, h_ins, dhf, chunk=chunk)
    got = ssd_bwd_chunk(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end,
                        chunk=chunk)
    torch.cuda.synchronize()
    names = ssd_kernel.bwd_kernels(dtype)  # bf16: the tensor-core ssd_bwd_chunk
    assert {k: LAUNCHES[k] - before.get(k, 0) for k in names} \
        == dict.fromkeys(names, 1)
    assert got[0].dtype == dtype
    _ssd_bwd_close("dS", dS, chunk_dstate_ref(dy, cum, C, chunk=chunk), dtype)
    for what, g, r in zip(("dchunk_in", "dh0", "end"), (dchunk_in, dh0, end),
                          state_pass_bwd_ref(dS, cum, h_ins, dhf, chunk=chunk)):
        _ssd_bwd_close(what, g, r, dtype)
    *ref, dA_scale = chunk_bwd_ref(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in,
                                   end, chunk=chunk, dA_scale=True)
    for what, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        _ssd_bwd_close(what, g, r, dtype, dA_scale if what == "dA" else None)


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", [
    (1, 2048, 48, 64, 1, 128, 256),   # mamba2-780m's training shape, batch 1
    (4, 2048, 48, 64, 1, 128, 256),   # ... and batch 4
    (2, 240, 12, 64, 2, 128, 24),     # two groups, a chunk not a multiple of 16
])
def test_ssd_bwd_dstate_tensor_cores_on_card(cuda_device, Bt, S, H, P, G, N,
                                             chunk):
    """bf16 ssd_bwd_dstate (the tensor-core kernel, one launch) against
    chunk_dstate_ref, with the model's A, within 2e-2 of the largest
    magnitude; the kernel it reports is csrc/ssd_bf16.cu's, no local
    memory."""
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, torch.bfloat16, Bt, S, H, P, G,
                                    N, True, seed=S + Bt)
    dy = torch.randn(x.shape, device=cuda_device).to(torch.bfloat16)
    cum = chunk_cumsum(dt, A, chunk)
    before = LAUNCHES["ssd_bwd_dstate"]
    got = ssd_bwd_dstate(dy, cum, C, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_bwd_dstate"] == before + 1
    _ssd_bwd_close("dS", got, chunk_dstate_ref(dy, cum, C, chunk=chunk),
                   torch.bfloat16)
    attrs = ssd_kernel.bwd_attributes("ssd_bwd_dstate", P, N, torch.bfloat16)
    assert attrs == ssd_kernel.attributes("ssd_bwd_dstate", P, N)
    assert attrs["local_bytes"] == 0, attrs


# The bf16 ssd_bwd_chunk's bars (csrc/ssd_bwd_tc.cu), as in
# tests/test_torch_cuda_emu.py: dx, written in bf16, 2e-2; the f32 ddt, dB,
# dC and dD 1e-4, which the hi + lo split of the f32 operands meets and one
# rounding of them to bf16 misses; dA 1e-3, above the f32 rounding floor of
# its cancelling terms (the f32 reference itself is 1.1e-4 from an f64
# evaluation at a 256-row chunk).
TC_BWD_TOL = {"dx": 2e-2, "ddt": 1e-4, "dA": 1e-3, "dB": 1e-4, "dC": 1e-4,
              "dD": 1e-4}


def _ssd_bwd_chunk_tc_at(head_block, x, dt, A, cum, B, C, D, dy, h_ins,
                         dchunk_in, end, chunk):
    """The tensor-core kernel by its C entry at another head block than the
    wrapper's, with the wrapper's partial sums."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2:]
    nc = S // chunk
    nhb = -(-(H // G) // head_block)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB_part, dC_part = (torch.full((nhb, Bt, S, G, N), float("nan"),
                                   device=x.device) for _ in range(2))
    dA_part, dD_part = (torch.empty(Bt, nc, H, device=x.device)
                        for _ in range(2))
    fn = load(ssd_kernel.BWD_TC_LIBRARY).ssd_bwd_chunk_tc
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    assert fn(*(t.data_ptr() for t in (x, dt, A, cum, B, C, D, dy, h_ins,
                                       dchunk_in, end, dx, ddt, dB_part,
                                       dC_part, dA_part, dD_part)),
              Bt, S, H, G, P, N, chunk, head_block,
              torch.cuda.current_stream().cuda_stream) == 0
    return (dx, ddt, dA_part.sum((0, 1)), dB_part.sum(0), dC_part.sum(0),
            dD_part.sum((0, 1)))


@pytest.mark.parametrize("head_block", [ssd_kernel.BWD_TC_HEAD_BLOCK, 1, 4, 13])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", [
    (1, 2048, 48, 64, 1, 128, 256),   # mamba2-780m's training shape, batch 1
    (4, 2048, 48, 64, 1, 128, 256),   # ... and batch 4
    (2, 240, 12, 64, 2, 128, 24),     # two groups, a chunk not a multiple of 16
    (1, 40, 6, 16, 3, 16, 5),         # three groups, a 5-row chunk
])
def test_ssd_bwd_chunk_tensor_cores_on_card(cuda_device, Bt, S, H, P, G, N,
                                            chunk, head_block):
    """bf16 ssd_bwd_chunk (the tensor-core kernel of csrc/ssd_bwd_tc.cu)
    against chunk_bwd_ref with the model's A, h_in from h0 and dchunk_in and
    the chunk-end term from the plain versions, within TC_BWD_TOL of each
    gradient's largest magnitude (dA: of its terms' magnitudes): through the
    wrapper at its head block (one launch counted as ssd_bwd_chunk_tc, none
    of the CUDA-core kernel), and by its C entry at others (1, a ragged 4,
    the shared memory's largest 13); the kernel uses no local memory."""
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, torch.bfloat16, Bt, S, H, P, G,
                                    N, True, seed=S + Bt + 3)
    rng = np.random.default_rng(S + 3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda_device)
    h0, dhf, dy = f(Bt, H, P, N), f(Bt, H, P, N), f(Bt, S, H, P).to(torch.bfloat16)
    cum = chunk_cumsum(dt, A, chunk)
    _, chunk_in = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    h_ins, _ = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]), h0)
    dchunk_in, _, end = state_pass_bwd_ref(chunk_dstate_ref(dy, cum, C, chunk=chunk),
                                           cum, h_ins, dhf, chunk=chunk)
    args = (x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end)
    before = dict(LAUNCHES)
    if head_block == ssd_kernel.BWD_TC_HEAD_BLOCK:
        got = ssd_bwd_chunk(*args, chunk=chunk)
    else:
        got = _ssd_bwd_chunk_tc_at(head_block, *args, chunk)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before.get(k, 0) for k in
            ("ssd_bwd_chunk", ssd_kernel.BWD_TC_KERNEL)} == {
        "ssd_bwd_chunk": 0,
        ssd_kernel.BWD_TC_KERNEL: int(head_block == ssd_kernel.BWD_TC_HEAD_BLOCK)}
    assert got[0].dtype == torch.bfloat16
    *ref, dA_scale = chunk_bwd_ref(*args, chunk=chunk, dA_scale=True)
    for what, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        g, r = _np(g), _np(r)
        scale = _np(dA_scale) if what == "dA" else np.abs(r).max()
        tol = TC_BWD_TOL[what]
        assert g.shape == r.shape and np.isfinite(g).all(), what
        assert (np.abs(g - r) - tol - tol * scale).max() <= 0, what
    attrs = ssd_kernel.bwd_attributes(ssd_kernel.BWD_TC_KERNEL, P, N,
                                      torch.bfloat16)
    assert attrs["local_bytes"] == 0, attrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk", [
    (1, 80, 4, 16, 2, 16, 32),    # padded to 96 inside ops.ssd
    (2, 48, 8, 16, 1, 16, 8),     # the reduced config's (P, N, chunk)
    (1, 96, 6, 32, 3, 16, 24)])
def test_ssd_function_vs_autograd_on_card(cuda_device, Bt, S, H, P, G, N, chunk,
                                          dtype):
    """``ops.ssd`` with grad on goes through ``SSDScan`` (the forward path of
    the input type, then the three backward kernels, one launch each); every
    input's gradient, h0's included, against autograd through
    ``ssd_chunked_ref``."""
    x, dt, A, B, C, D = _ssd_inputs(cuda_device, dtype, Bt, S, H, P, G, N, True,
                                    seed=S + 5)
    rng = np.random.default_rng(S)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda_device)
    h0, dhf, dy = f(Bt, H, P, N), f(Bt, H, P, N), f(Bt, S, H, P).to(dtype)
    grads = {}
    for impl in ("auto", "reference"):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D, h0)]
        LAUNCHES.clear()
        y, h = ssd(*leaves[:6], chunk=chunk, h0=leaves[6], impl=impl)
        grads[impl] = torch.autograd.grad([y, h], leaves, [dy, dhf])
        torch.cuda.synchronize()
        if impl == "auto":
            fwd = BF16_KERNELS if dtype == torch.bfloat16 else ("ssd_chunk",)
            assert dict(LAUNCHES) == dict.fromkeys(
                fwd + ssd_kernel.bwd_kernels(dtype), 1)
    for what, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"),
                          *grads.values()):
        assert g.dtype == r.dtype, what
        _ssd_bwd_close(what, g, r, dtype)


def test_rglru_function_vs_autograd_on_card(cuda_device):
    """``ops.rglru_scan`` with grad on goes through ``RGLRUScan`` (one launch
    of each kernel); the gradients of a, u and h0 against autograd through
    ``rglru_scan_ref``."""
    a, u, h0 = _rglru_inputs(cuda_device, torch.float32, 2, 300, 100, True,
                             True, seed=3)
    dh = torch.randn(a.shape, device=cuda_device)
    grads = {}
    for impl in ("auto", "sequential"):
        leaves = [t.clone().requires_grad_() for t in (a, u, h0)]
        LAUNCHES.clear()
        hs, _ = rglru_scan(*leaves, impl=impl)
        grads[impl] = torch.autograd.grad(hs, leaves, dh)
        if impl == "auto":
            assert dict(LAUNCHES) == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    for g, r in zip(*grads.values()):
        np.testing.assert_allclose(_np(g), _np(r), **RGLRU_TOL)


@pytest.mark.parametrize("P,N", ssd_kernel.PN_PAIRS)
@pytest.mark.parametrize("name,dtype", [
    *((name, dtype) for name in ssd_kernel.BWD_KERNELS
      for dtype in (torch.float32, torch.bfloat16)),
    (ssd_kernel.BWD_TC_KERNEL, torch.bfloat16)])
def test_ssd_bwd_kernels_use_no_local_memory(cuda_device, name, P, N, dtype):
    attrs = ssd_kernel.bwd_attributes(name, P, N, dtype)
    assert attrs["local_bytes"] == 0, attrs


# Launches per training step of the reduced recurrent configs (f32 compute):
# each superblock's forward twice (the step's and the rematerialised
# recompute), each backward kernel once a layer.  mamba2-780m: 2 SSM layers
# (the f32 path: ssd_chunk); recurrentgemma-2b: one superblock (RG-LRU,
# RG-LRU, attention) and 2 RG-LRU tail layers.
REDUCED_TRAIN_LAUNCHES = {
    "mamba2-780m": {"ssd_chunk": 4, **dict.fromkeys(ssd_kernel.BWD_KERNELS, 2)},
    "recurrentgemma-2b": {"rglru_scan": 6, "rglru_scan_bwd": 4,
                          "flash_attn_fwd": 2, **dict.fromkeys(BWD_KERNELS, 1)},
}


@pytest.mark.parametrize("arch", sorted(REDUCED_TRAIN_LAUNCHES))
def test_reduced_recurrent_train_step_on_card_matches_cpu(cuda_device, arch):
    """One train step of a reduced recurrent config on the card, through the
    kernels of its blocks and their backward kernels: loss, grad_norm and the
    updated parameters as on the CPU from the same weights and batch."""
    cfg = ARCHS[arch].reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0)).tree()
    gpu = unflatten({k: t.to(cuda_device) for k, t in flatten(cpu).items()})
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 33)).astype(
        np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    step = make_train_step(cfg)
    LAUNCHES.clear()
    gstate, gm = step({"params": gpu, "opt": init_opt_state(gpu)},
                      {k: t.to(cuda_device) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == REDUCED_TRAIN_LAUNCHES[arch]
    cstate, cm = step({"params": cpu, "opt": init_opt_state(cpu)}, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(gm[key]), _np(cm[key]), rtol=1e-5, atol=1e-5)
    g, c = flatten(gstate["params"]), flatten(cstate["params"])
    for key in c:
        np.testing.assert_allclose(_np(g[key]), _np(c[key]), rtol=0, atol=1.2e-5,
                                   err_msg=key)


# Full-width training steps (chip_smoke.py's cells): launches per step, each
# superblock's forward twice and each backward kernel once a layer.
FULL_TRAIN = {
    "mamba2-780m": (4, {"ssd_chunk_state": 96, "ssd_state_pass": 96,
                        "ssd_chunk_scan": 96,
                        **dict.fromkeys(ssd_kernel.BF16_BWD_KERNELS, 48)}),
    "recurrentgemma-2b": (1, {"rglru_scan": 34, "rglru_scan_bwd": 18,
                              "flash_attn_fwd": 16,
                              **dict.fromkeys(BWD_KERNELS, 8)}),
    "granite-moe-3b-a800m": (4, {"flash_attn_fwd": 64,
                                 **dict.fromkeys(BWD_KERNELS, 32)}),
    "whisper-medium": (4, {"flash_attn_fwd": 96,
                           **dict.fromkeys(BWD_KERNELS, 48)}),
}


@pytest.mark.parametrize("arch", sorted(FULL_TRAIN))
def test_full_width_train_step_on_card(cuda_device, arch):
    """One full-width training step (random weights, batch x 2048): a finite
    loss and gradient norm, and exactly its kernels' launches."""
    batch_size, want = FULL_TRAIN[arch]
    cfg = ARCHS[arch]
    params = init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                         trainable=True).tree()
    toks = np.random.default_rng(5).integers(0, cfg.vocab,
                                             size=(batch_size, 2049)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(cuda_device),
             "labels": torch.from_numpy(toks[:, 1:]).to(cuda_device),
             **_frames(cfg, batch_size, cuda_device)}
    LAUNCHES.clear()
    _, metrics = make_train_step(cfg)({"params": params,
                                       "opt": init_opt_state(params)}, batch)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == want
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(
        float(metrics["grad_norm"]))
    del params
    torch.cuda.empty_cache()


def test_local_cloud_trains_reduced_jobs_on_card(cuda_device, tmp_path):
    """The physical mode on the card (its default device): Eva schedules two
    reduced 30-step jobs, each worker on its own stream, to completion, and
    every step of both runs the flash forward (twice a layer, with the
    recompute) and each flash backward kernel (once a layer)."""
    catalog = Catalog.from_types([
        InstanceType("local.large", "c7i", (0, 4, 16), 1.0),
        InstanceType("local.small", "c7i", (0, 2, 8), 0.55),
    ])
    jobs = [LocalJob(job_id=1, workload=7, arch_cfg=ARCHS["smollm-135m"].reduced(),
                     total_steps=30, demand=(0, 1, 4), standalone_sps=20.0),
            LocalJob(job_id=2, workload=6, arch_cfg=ARCHS["qwen3-0.6b"].reduced(),
                     total_steps=30, demand=(0, 1, 4), standalone_sps=15.0)]
    cloud = LocalCloud(catalog, EvaScheduler(catalog), jobs, round_s=1.0,
                       workdir=str(tmp_path))
    LAUNCHES.clear()
    out = cloud.run(timeout_s=300)
    assert out["all_done"], out
    assert out["cost"] > 0
    layers = sum(j.arch_cfg.n_layers * j.total_steps for j in jobs)
    assert dict(LAUNCHES) == {"flash_attn_fwd": 2 * layers,
                              **dict.fromkeys(BWD_KERNELS, layers)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,max_fills", PACK_CASES)
def test_pack_fill_vs_plain_on_card(cuda_device, case, max_fills, dtype):
    """The packing kernel at its default launch, the warp kernel at every L
    of PER_LANE with 32 L >= C, and the block kernel at 128 threads, against
    ``pack_all_types_ref`` from the same inputs: the budget left, every kept
    record, the record count and the overflow flag equal, one launch each."""
    args = pack_case(case, dtype)
    want = pack_all_types_ref(*args, max_fills=max_fills)
    n = int(want[4])
    kept = min(n, max_fills)
    C = args[0].shape[0]
    for per_lane, threads in ([(None, None)] + [(L, None) for L in PER_LANE
                                                 if 32 * L >= C] + [(0, 128)]):
        LAUNCHES.clear()
        got = [t.cpu() for t in pack_fill(*(a.to(cuda_device) for a in args),
                                          max_fills=max_fills,
                                          per_lane=per_lane, threads=threads)]
        assert dict(LAUNCHES) == {"pack_fill": 1}
        assert torch.equal(got[0], want[0])
        assert int(got[4]) == n and bool(got[5]) == bool(want[5])
        for a, b in zip(got[1:4], want[1:4]):
            assert torch.equal(a[:kept], b[:kept])
