"""The kernels' own C++ on the CPU: ``csrc/rglru_scan.cu``,
``csrc/ssd_bwd.cu``, the tensor-core ``csrc/ssd_bwd_tc.cu`` and the packing
pass ``csrc/pack_fill.cu`` built with g++
against ``tools/cuda_emu/cuda_emu.h`` (one fiber per CUDA thread, barriers
for ``__syncthreads`` and the warp shuffles, votes and reductions, and for
``ssd_bwd_tc.cu`` its cp.async, ldmatrix and mma.sync), called through their
``extern "C"``
entries with CPU tensors, and held against their plain versions at small
shapes, at the card's tolerances (``tests/test_torch_cuda.py``): the RG-LRU
kernels to the bit against their chunked mirrors (the same rounded sums and
products in the same order), and against the sequential oracles to the bit
with one chunk, else within 1e-5 in f32 and one bf16 step in bf16; the SSD backward 1e-4 of each gradient's
largest magnitude (dA: of the sum of its terms' magnitudes; dchunk_in and
dh0 elementwise) in f32, 2e-2 with bf16 inputs; the packing pass's records,
budget and counts equal to ``pack_all_types_ref``'s (the same rounded
products and sums in the same order; f32 and f64, interference on and off,
a type mask, region budgets, more than 64 classes, an overflowing record
buffer, the warp kernel at every classes-a-lane count that covers the
fleet, and the block kernel, with its per-class state in shared memory and
in global scratch).  What the emulation cannot
show (speed, registers, spills, the card's own compiler and its tensor
cores' own rounding of sums) ``chip_smoke.py`` shows.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.pack_fill.kernel import PER_LANE
from repro_torch.kernels.pack_fill.ref import pack_all_types_ref
from torch_pack_cases import PACK_CASES, pack_case
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_chunked_ref,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_chunked_ref,
                                                rglru_scan_ref)
from repro_torch.kernels.ssd_scan.ref import (chunk_bwd_ref, chunk_cumsum,
                                              chunk_dstate_ref, pass_states,
                                              ssd_chunk_ref, state_pass_bwd_ref)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels"
V, I = ctypes.c_void_p, ctypes.c_int
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RGLRU_TOL = 1e-5  # chip_smoke.py's: f32 sums and products taken in another order
# The bf16 ssd_bwd_chunk's bars (csrc/ssd_bwd_tc.cu), by gradient: dx is
# written in bf16 (2e-2); ddt, dB, dC and dD are f32 and held at 1e-4, which
# the hi + lo split of the f32 operands meets and one rounding of them to
# bf16 misses (tests/test_torch_ssd_scan.py).  dA sums its terms over every
# row after a reverse cumsum of differences that cancel: at a 256-row chunk
# with the model's fastest decay the f32 reference is itself 1.1e-4 of the
# terms' magnitude from an f64 evaluation, and ssd_bwd.cu's all-f32 kernel
# 2.6e-4 from the reference, so dA is held at 1e-3, above f32's own floor.
TC_BWD_TOL = {"dx": 2e-2, "ddt": 1e-4, "dA": 1e-3, "dB": 1e-4, "dC": 1e-4,
              "dD": 1e-4}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    built = {}
    for name, src in (("rglru", CSRC / "rglru_scan/csrc/rglru_scan.cu"),
                      ("ssd", CSRC / "ssd_scan/csrc/ssd_bwd.cu"),
                      ("ssd_tc", CSRC / "ssd_scan/csrc/ssd_bwd_tc.cu"),
                      ("pack", CSRC / "pack_fill/csrc/pack_fill.cu")):
        lib = out / f"lib{name}.so"
        proc = subprocess.run([sys.executable, str(ROOT / "tools/cuda_emu/build.py"),
                               str(src), str(lib)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        built[name] = ctypes.CDLL(str(lib))
    built["rglru"].rglru_scan.argtypes = [V] * 7 + [I] * 5 + [V]
    built["rglru"].rglru_scan_bwd.argtypes = [V] * 9 + [I] * 5 + [V]
    built["rglru"].rglru_scan_kernel_launches.restype = ctypes.c_ulonglong
    built["ssd"].ssd_bwd_dstate.argtypes = [V] * 4 + [I] * 8 + [V]
    built["ssd"].ssd_bwd_state_pass.argtypes = [V] * 7 + [I] * 6 + [V]
    built["ssd"].ssd_bwd_chunk.argtypes = [V] * 17 + [I] * 9 + [V]
    built["ssd_tc"].ssd_bwd_chunk_tc.argtypes = [V] * 17 + [I] * 8 + [V]
    built["pack"].pack_fill.argtypes = [V] * 13 + [I] * 11 + [V] * 7
    return built


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R,h0,dhf,chunk", [
    # one chunk (chunk >= S): the sequential oracles' bits
    pytest.param(2, 37, 70, True, True, None, id="2-37-70-True-True"),
    pytest.param(1, 20, 64, False, False, None, id="1-20-64-False-False"),
    # C > 1: chunks that do not divide S, with and without h0 and dh_final
    pytest.param(2, 37, 70, True, True, 16, id="2-37-70-True-True-chunk16"),
    pytest.param(2, 300, 100, False, True, 64, id="2-300-100-False-True-chunk64"),
    pytest.param(1, 37, 5, True, False, 5, id="1-37-5-True-False-chunk5"),
])
def test_rglru_kernels_emulated(libs, B, S, R, h0, dhf, chunk, dtype):
    """The scan (h_seq, h_final and the f32 states) and its backward in
    chunks of ``chunk`` steps (None: one chunk) against the chunked mirrors
    ``rglru_scan_chunked_ref`` and ``rglru_scan_bwd_chunked_ref`` with the
    same chunk, to the bit, and against the sequential ``rglru_scan_ref`` and
    ``rglru_scan_bwd_ref``: to the bit with one chunk, else within
    ``RGLRU_TOL`` (f32; bf16 outputs one bf16 step); each entry's CUDA
    launches as the library counts them, two in more than one chunk."""
    g = torch.Generator().manual_seed(S + R)
    a = (0.5 + 0.499 * torch.rand(B, S, R, generator=g)).to(dtype)
    u = torch.randn(B, S, R, generator=g).to(dtype)
    h = torch.randn(B, R, generator=g) if h0 else None
    one = chunk is None
    chunk = S if one else chunk
    C = -(-S // chunk)
    ws = torch.empty(2, B, C, R) if C > 1 else None
    hs, hf, hst = torch.empty_like(u), torch.empty(B, R), torch.empty(B, S, R)
    isbf = int(dtype == torch.bfloat16)
    launches = libs["rglru"].rglru_scan_kernel_launches
    before = launches()
    assert libs["rglru"].rglru_scan(_ptr(a), _ptr(u), _ptr(h), _ptr(hs), _ptr(hf),
                                    _ptr(hst), _ptr(ws), B, S, R, chunk, isbf,
                                    None) == 0
    assert launches() == before + (2 if C > 1 else 1)
    mirror, mirror_final = rglru_scan_chunked_ref(a, u, h, chunk)
    assert torch.equal(hs, mirror) and torch.equal(hf, mirror_final)
    assert torch.equal(hst, rglru_scan_chunked_ref(a.float(), u.float(), h,
                                                   chunk)[0])
    ref, ref_final = rglru_scan_ref(a, u, h)
    if one:
        assert torch.equal(hs, ref) and torch.equal(hf, ref_final)
        assert torch.equal(hst, rglru_scan_ref(a.float(), u.float(), h)[0])
    _within(hs, ref, dtype)
    _within(hf, ref_final, torch.float32)
    dh = torch.randn(B, S, R, generator=g).to(dtype)
    dh_final = torch.randn(B, R, generator=g) if dhf else None
    da, du, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty(B, R)
    assert libs["rglru"].rglru_scan_bwd(_ptr(a), _ptr(hst), _ptr(h), _ptr(dh),
                                        _ptr(dh_final), _ptr(ws), _ptr(da),
                                        _ptr(du), _ptr(dh0), B, S, R, chunk,
                                        isbf, None) == 0
    assert launches() == before + 2 * (2 if C > 1 else 1)
    first = torch.zeros(B, 1, R) if h is None else h[:, None]
    h_prev = torch.cat([first, hst[:, :-1]], 1)
    mirror = rglru_scan_bwd_chunked_ref(a, h_prev, dh, dh_final, chunk)
    oracle = rglru_scan_bwd_ref(a, h_prev, dh, dh_final)
    for got, want, ref in zip((da, du, dh0), mirror, oracle):
        assert torch.equal(got, want)
        if one:
            assert torch.equal(got, ref)
        _within(got, ref, got.dtype)


def _within(got, ref, dtype):
    """RGLRU_TOL (1e-5 abs + rel) in f32, one bf16 step (8e-3) in bf16."""
    tol = RGLRU_TOL if dtype == torch.float32 else 8e-3
    d = (got.float() - ref.float()).abs()
    assert bool(torch.isfinite(got.float()).all())
    assert (d - tol - tol * ref.float().abs()).max().item() <= 0


def _close(what, got, ref, dtype, scale=None, tol=None):
    tol = SSD_TOL[dtype] if tol is None else tol
    got, ref = got.float().numpy(), ref.float().numpy()
    if scale is None:
        scale = np.abs(ref) if what in ("dchunk_in", "dh0") else np.abs(ref).max()
    else:
        scale = scale.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    assert (np.abs(got - ref) - tol - tol * scale).max() <= 0, what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,hb", [
    (1, 16, 4, 16, 2, 16, 8, 2),    # the reduced configs' (P, N, chunk), G 2
    (1, 48, 6, 32, 3, 16, 24, 4),   # G 3, a chunk that is not a multiple of 32
    (2, 10, 2, 16, 1, 32, 5, 1),    # a 5-row chunk
    (1, 64, 3, 64, 1, 128, 64, 3),  # mamba2-780m's (P, N), a ragged head block
])
def test_ssd_bwd_kernels_emulated(libs, Bt, S, H, P, G, N, chunk, hb, dtype):
    """ssd_bwd_dstate, ssd_bwd_state_pass and ssd_bwd_chunk against
    ``chunk_dstate_ref``, ``state_pass_bwd_ref`` and ``chunk_bwd_ref`` from
    the same inputs, with h0 and dh_final, the model's kind of A."""
    g = torch.Generator().manual_seed(S * H + P)
    x = torch.randn(Bt, S, H, P, generator=g).to(dtype)
    dt = 0.1 + 0.8 * torch.rand(Bt, S, H, generator=g)
    A = -torch.linspace(1.0, 16.0, H)
    B = torch.randn(Bt, S, G, N, generator=g).to(dtype)
    C = torch.randn(Bt, S, G, N, generator=g).to(dtype)
    D = torch.randn(H, generator=g)
    h0, dhf = (torch.randn(Bt, H, P, N, generator=g) for _ in range(2))
    dy = torch.randn(Bt, S, H, P, generator=g).to(dtype)
    nc = S // chunk
    cum = chunk_cumsum(dt, A, chunk)
    _, chunk_in = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    h_ins, _ = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]), h0)
    lib, isbf = libs["ssd"], int(dtype == torch.bfloat16)

    dS = torch.empty(Bt, nc, H, P, N)
    assert lib.ssd_bwd_dstate(_ptr(dy), _ptr(cum), _ptr(C), _ptr(dS), Bt, S, H, G,
                              P, N, chunk, isbf, None) == 0
    _close("dS", dS, chunk_dstate_ref(dy, cum, C, chunk=chunk), dtype)

    parts = -(-(P * N // 4) // 256)
    dchunk_in, dh0 = torch.empty_like(dS), torch.empty(Bt, H, P, N)
    end_part = torch.empty(Bt, nc, H, parts)
    assert lib.ssd_bwd_state_pass(_ptr(dS), _ptr(cum), _ptr(h_ins), _ptr(dhf),
                                  _ptr(dchunk_in), _ptr(dh0), _ptr(end_part), Bt,
                                  S, H, P, N, chunk, None) == 0
    end = end_part.sum(-1)
    for what, got, want in zip(("dchunk_in", "dh0", "end"), (dchunk_in, dh0, end),
                               state_pass_bwd_ref(dS, cum, h_ins, dhf, chunk=chunk)):
        _close(what, got, want, dtype)

    nhb = -(-(H // G) // hb)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB_part, dC_part = torch.empty(nhb, Bt, S, G, N), torch.zeros(nhb, Bt, S, G, N)
    dA_part, dD_part = torch.empty(Bt, nc, H), torch.empty(Bt, nc, H)
    assert lib.ssd_bwd_chunk(*map(_ptr, (x, dt, A, cum, B, C, D, dy, h_ins,
                                         dchunk_in, end, dx, ddt, dB_part, dC_part,
                                         dA_part, dD_part)),
                             Bt, S, H, G, P, N, chunk, hb, isbf, None) == 0
    *want, dA_scale = chunk_bwd_ref(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in,
                                    end, chunk=chunk, dA_scale=True)
    got = (dx, ddt, dA_part.sum((0, 1)), dB_part.sum(0), dC_part.sum(0),
           dD_part.sum((0, 1)))
    assert dx.dtype == dtype
    for what, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        _close(what, a, b, dtype, dA_scale if what == "dA" else None)


@pytest.mark.parametrize("Bt,S,H,P,G,N,chunk,hb", [
    (1, 16, 4, 16, 2, 16, 8, 2),      # the reduced configs' (P, N, chunk), G 2
    (1, 48, 6, 32, 3, 16, 24, 4),     # G 3, a chunk that is not a multiple of 16
    (2, 10, 2, 16, 1, 32, 5, 1),      # a 5-row chunk
    (1, 64, 3, 64, 1, 128, 64, 2),    # mamba2-780m's (P, N), a ragged head block
    (1, 256, 2, 64, 1, 128, 256, 2),  # ... and its 256-row chunk: both rounds
])
def test_ssd_bwd_chunk_tensor_cores_emulated(libs, Bt, S, H, P, G, N, chunk, hb):
    """The bf16 ssd_bwd_chunk (``csrc/ssd_bwd_tc.cu``) against
    ``chunk_bwd_ref`` from the same inputs (dchunk_in and the chunk-end term
    from the plain versions, h0 and dh_final given, the model's kind of A),
    each gradient within TC_BWD_TOL of its largest magnitude (dA: of the sum
    of its terms' magnitudes); dB and dC written in full by the kernel (no
    zeroed partials), dx in bf16."""
    g = torch.Generator().manual_seed(S * H + P)
    bf = torch.bfloat16
    x = torch.randn(Bt, S, H, P, generator=g).to(bf)
    dt = 0.1 + 0.8 * torch.rand(Bt, S, H, generator=g)
    A = -torch.linspace(1.0, 16.0, H)
    B = torch.randn(Bt, S, G, N, generator=g).to(bf)
    C = torch.randn(Bt, S, G, N, generator=g).to(bf)
    D = torch.randn(H, generator=g)
    h0, dhf = (torch.randn(Bt, H, P, N, generator=g) for _ in range(2))
    dy = torch.randn(Bt, S, H, P, generator=g).to(bf)
    nc = S // chunk
    cum = chunk_cumsum(dt, A, chunk)
    _, chunk_in = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    h_ins, _ = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]), h0)
    dchunk_in, _, end = state_pass_bwd_ref(chunk_dstate_ref(dy, cum, C, chunk=chunk),
                                           cum, h_ins, dhf, chunk=chunk)
    nhb = -(-(H // G) // hb)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB_part, dC_part = (torch.full((nhb, Bt, S, G, N), float("nan")) for _ in range(2))
    dA_part, dD_part = torch.empty(Bt, nc, H), torch.empty(Bt, nc, H)
    assert libs["ssd_tc"].ssd_bwd_chunk_tc(
        *map(_ptr, (x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end, dx, ddt,
                    dB_part, dC_part, dA_part, dD_part)),
        Bt, S, H, G, P, N, chunk, hb, None) == 0
    *want, dA_scale = chunk_bwd_ref(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in,
                                    end, chunk=chunk, dA_scale=True)
    got = (dx, ddt, dA_part.sum((0, 1)), dB_part.sum(0), dC_part.sum(0),
           dD_part.sum((0, 1)))
    assert dx.dtype == bf
    for what, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        _close(what, a, b, bf, dA_scale if what == "dA" else None,
               tol=TC_BWD_TOL[what])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,max_fills", PACK_CASES)
def test_pack_fill_emulated(libs, case, max_fills, dtype):
    """``pack_fill.cu`` against ``pack_all_types_ref`` from the same inputs:
    the budget left, every kept record, the record count and the overflow
    flag equal, for the warp kernel at every L of PER_LANE with 32 L >= C
    (registers and warp collectives alone), and for the block kernel at two
    warps (shared-memory partials and barriers) and with its per-class state
    in a global scratch buffer."""
    args = pack_case(case, dtype)
    C, F, R = args[0].shape
    W, K, M, NR = args[6].shape[0], args[8].shape[0], args[5].shape[1], \
        args[12].numel()
    want = pack_all_types_ref(*args, max_fills=max_fills)
    n = int(want[4])
    assert n > max_fills if max_fills == 3 else n <= max_fills
    kept = min(n, max_fills)
    scratch = torch.zeros(1 << 16, dtype=torch.uint8)
    launches = [(L, 32, None) for L in PER_LANE if 32 * L >= C]
    launches += [(0, 64, None), (0, 32, scratch)]
    assert case != "many" or launches[0][0] == 4  # > 64 classes
    for per_lane, threads, scr in launches:
        budget = torch.empty_like(args[12])
        rec_type = torch.full((max_fills,), -1, dtype=torch.int32)
        rec_rep = torch.zeros(max_fills, dtype=torch.int32)
        rec_comp = torch.zeros(max_fills, C, dtype=torch.int32)
        stats = torch.zeros(4, dtype=torch.int64)
        assert libs["pack"].pack_fill(
            *map(_ptr, args), C, F, R, M, W, K, NR, max_fills,
            int(dtype == torch.float64), per_lane, threads,
            *map(_ptr, (budget, rec_type, rec_rep, rec_comp, stats, scr)),
            None) == 0
        assert torch.equal(budget, want[0])
        for got, ref in zip((rec_type, rec_rep, rec_comp), want[1:4]):
            assert torch.equal(got[:kept], ref[:kept])
        assert stats[:2].tolist() == [n, int(bool(want[5]))]
        assert stats[2] >= n and stats[3] >= n  # adds, fills
