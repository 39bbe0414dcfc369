"""ctypes wrappers of the CUDA SSD kernels, the port of ``ssd_chunk_pallas``.

- ``ssd_chunk`` (``csrc/ssd_chunk.cu``): the intra-chunk term and each
  chunk's input to the state, on the CUDA cores in f32; ``ops.ssd`` takes it
  for f32 inputs.
- ``ssd_chunk_state``, ``ssd_state_pass`` and ``ssd_chunk_scan``
  (``csrc/ssd_bf16.cu``): the whole SSD for bf16 inputs, its products on the
  tensor cores, y written once; ``ops.ssd`` takes them for bf16 inputs.
- ``ssd_bwd_dstate``, ``ssd_bwd_state_pass`` and ``ssd_bwd_chunk``
  (``csrc/ssd_bwd.cu``): the gradient of the whole SSD in either input type,
  on the CUDA cores in f32, but in bf16 ``ssd_bwd_dstate`` runs the
  tensor-core kernel of ``csrc/ssd_bf16.cu`` and ``ssd_bwd_chunk`` that of
  ``csrc/ssd_bwd_tc.cu`` (counted as ``ssd_bwd_chunk_tc``); ``ops.SSDScan``
  runs them.  They have no TPU counterpart: the JAX package differentiates
  its jnp path.

On a CPU tensor each wrapper computes its kernel's plain version (``ref``);
on a CUDA tensor it checks its inputs, launches the kernel and counts the
launch in ``LAUNCHES`` under its own name, or raises.  The launches are
registered as custom ops (``repro_torch::<name>``) that a fake tensor goes
through (``kernels.run``): shapes alone, and the products each kernel
computes (``kernels.flops``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import count_launch, flops, run
from ..build import load
from .ref import (chunk_bwd_ref, chunk_cumsum, chunk_dstate_ref, chunk_scan_ref,
                  chunk_state_ref, pass_states, ssd_chunk_ref, state_pass_bwd_ref)

NAME = "ssd_chunk"
BF16_LIBRARY = "ssd_bf16"
# (head dim P, state N) instantiated in both .cu files: (16, 16) the reduced
# configs', (16, 32) and (32, 16) the test grid's, (64, 128) mamba2-780m's
PN_PAIRS = ((16, 16), (16, 32), (32, 16), (64, 128))
MAX_CHUNK = 256
# Heads a block of ssd_chunk_state and of ssd_chunk_scan walks (fewer at a
# group's end): B and C.B^T are staged and formed once for them.  The fastest
# of 1..16 and of 3..24 at mamba2-780m's serving shape on the H100
# (tools/ssd_tune.py, PERF.md).  The bf16 ssd_bwd_dstate, the same product
# with dy for x and C for B, takes STATE_HEAD_BLOCK too.
STATE_HEAD_BLOCK = 6
SCAN_HEAD_BLOCK = 12
BWD_LIBRARY = "ssd_bwd"
BWD_KERNELS = ("ssd_bwd_dstate", "ssd_bwd_state_pass", "ssd_bwd_chunk")
# Heads a block of ssd_bwd_chunk walks (at most 4, as in the .cu file); dB
# and dC are summed over them in the block, and over the head blocks by
# PyTorch.  The fastest of 1..4 at mamba2-780m's training shape on the H100
# (tools/ssd_bwd_tune.py, PERF.md).
BWD_HEAD_BLOCK = 3
# The bf16 ssd_bwd_chunk (csrc/ssd_bwd_tc.cu): its library, launch count
# name, and the heads a block walks (dB and dC summed over them in the
# block); the fastest of those tools/ssd_bwd_tc_tune.py times at mamba2-780m's
# training shape on the H100 (PERF.md).  At most 13 at (P, N) = (64, 128)
# (shared memory, TcLayout in the .cu file).
BWD_TC_LIBRARY = "ssd_bwd_tc"
BWD_TC_KERNEL = "ssd_bwd_chunk_tc"
BWD_TC_HEAD_BLOCK = 12
BF16_BWD_KERNELS = ("ssd_bwd_dstate", "ssd_bwd_state_pass", BWD_TC_KERNEL)
_BWD_PASS_THREADS = 256  # state elements / 4 a block of ssd_bwd_state_pass covers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_X = 2 ** 31 - 1
_MAX_GRID_Y = 65535


@functools.cache
def _function(library: str, name: str, n_ptr: int, n_int: int):
    fn = getattr(load(library), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bwd_kernels(dtype: torch.dtype) -> tuple:
    """The launch count names of the SSD backward's kernels for x's type."""
    return BF16_BWD_KERNELS if dtype == torch.bfloat16 else BWD_KERNELS


def _check(x, dt, cum, B, C, chunk, dtypes=tuple(_DTYPES)):
    """The checks every SSD kernel shares; cum and C may be None (not an
    input)."""
    cum = dt if cum is None else cum
    C = B if C is None else C
    if x.dim() != 4 or dt.dim() != 3 or cum.dim() != 3 or B.dim() != 4 \
            or C.dim() != 4:
        raise ValueError("x must be (Bt, S, H, P), dt and cum (Bt, S, H), "
                         "B and C (Bt, S, G, N)")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dt.shape != (Bt, S, H) or cum.shape != (Bt, S, H) \
            or B.shape != (Bt, S, G, N) or C.shape != B.shape:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, cum {tuple(cum.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if Bt < 1 or S < 1 or G < 1 or H % G:
        raise ValueError(f"bad sizes or head counts: Bt={Bt} S={S} H={H} G={G}")
    if (P, N) not in PN_PAIRS:
        raise ValueError(f"(P, N) = ({P}, {N}) is not instantiated in the "
                         f"kernel; it takes {PN_PAIRS}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must lie in 1..{MAX_CHUNK} and divide "
                         f"S={S} (ops.ssd pads to a chunk multiple)")
    if x.dtype not in dtypes or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}, {B.dtype}, {C.dtype}: x, B and C "
                        f"must be one of {[str(d) for d in dtypes]}, the same "
                        "for all three")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"dt and cum must be float32, got {dt.dtype}, {cum.dtype}")


def _check_device(*tensors):
    """One CUDA device, contiguous; None entries are skipped."""
    tensors = [t for t in tensors if t is not None]
    if len({t.device for t in tensors}) != 1 or tensors[0].device.type != "cuda":
        raise ValueError("the inputs must lie on one CUDA device: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the inputs must be contiguous")


def _check_aligned(*tensors):
    """16-byte aligned, for the bf16 kernels, which copy rows in 16-byte
    pieces (checked in the op, on the tensors the kernel reads); None
    entries are skipped."""
    if any(t.data_ptr() % 16 for t in tensors if t is not None):
        raise ValueError("the inputs must start on a 16-byte boundary")


def _launch(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    count_launch(name)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x: (Bt, S, H, P); dt, cum: (Bt, S, H) f32; B, C: (Bt, S, G, N).

    Returns (y_intra (Bt, S, H, P), chunk_in (Bt, S/chunk, H, P, N)), f32."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    _check(x, dt, cum, B, C, chunk)
    _check_device(x, dt, cum, B, C)
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if S // chunk > _MAX_GRID_Y or Bt * H >= 2 ** 31:
        raise ValueError(f"S/chunk={S // chunk}, Bt*H={Bt * H} exceed the "
                         "kernel's grid")
    return run(_chunk_op, _chunk_launch, x, dt, cum, B, C, chunk)


def _chunk_launch(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = S // chunk
    y = torch.empty(Bt, S, H, P, dtype=torch.float32, device=x.device)
    chunk_in = torch.empty(Bt, nc, H, P, N, dtype=torch.float32, device=x.device)
    _launch(NAME, _function(NAME, "ssd_chunk", 7, 8),
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), chunk_in.data_ptr(),
            Bt, S, H, G, P, N, chunk, _DTYPES[x.dtype], device=x.device)
    return y, chunk_in


_chunk_op = torch.library.custom_op(
    "repro_torch::ssd_chunk", mutates_args=())(_chunk_launch)


@_chunk_op.register_fake
def _(x, dt, cum, B, C, chunk):
    Bt, S, H, P = x.shape
    return (x.new_empty((Bt, S, H, P), dtype=torch.float32),
            x.new_empty((Bt, S // chunk, H, P, B.shape[3]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_chunk)
def _(x, dt, cum, B, C, chunk, *args, **kwargs) -> int:
    Bt, S, H, P = x
    return flops.ssd_chunk(Bt, S, H, P, B[2], B[3], chunk)


def _check_grid(x, B, chunk: int, head_block: int) -> None:
    """ssd_chunk_state and ssd_chunk_scan take a block per (batch * chunk,
    group, head block)."""
    Bt, S, H, _ = x.shape
    G = B.shape[2]
    blocks = Bt * (S // chunk) * G * -(-(H // G) // head_block)
    if blocks > _MAX_GRID_X:
        raise ValueError(f"{blocks} blocks exceed the kernel's grid")


def ssd_chunk_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, *, chunk: int):
    """x: (Bt, S, H, P) bf16; dt: (Bt, S, H) f32; A: (H,) f32; B:
    (Bt, S, G, N) bf16.

    Returns (chunk_in (Bt, S/chunk, H, P, N), cum (Bt, S, H)), f32: each
    chunk's input to the state (``chunk_state_ref``) and the within-chunk
    cumsum of A.dt (``chunk_cumsum``, to the bit)."""
    if x.device.type == "cpu":
        cum = chunk_cumsum(dt, A, chunk)
        return chunk_state_ref(x, dt, cum, B, chunk=chunk), cum
    _check(x, dt, None, B, None, chunk, dtypes=(torch.bfloat16,))
    if A.shape != (x.shape[2],) or A.dtype != torch.float32:
        raise ValueError(f"A must be ({x.shape[2]},) float32, got "
                         f"{tuple(A.shape)} {A.dtype}")
    _check_grid(x, B, chunk, STATE_HEAD_BLOCK)
    _check_device(x, dt, A, B)
    return run(_chunk_state_op, _chunk_state_launch, x, dt, A, B,
               chunk)


def _chunk_state_launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, chunk: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    _check_aligned(x, dt, A, B)
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    chunk_in = torch.empty(Bt, S // chunk, H, P, N, dtype=torch.float32,
                           device=x.device)
    cum = torch.empty_like(dt)
    _launch("ssd_chunk_state", _function(BF16_LIBRARY, "ssd_chunk_state", 6, 8),
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            chunk_in.data_ptr(), cum.data_ptr(), Bt, S, H, G, P, N, chunk,
            STATE_HEAD_BLOCK, device=x.device)
    return chunk_in, cum


_chunk_state_op = torch.library.custom_op(
    "repro_torch::ssd_chunk_state", mutates_args=())(_chunk_state_launch)


@_chunk_state_op.register_fake
def _(x, dt, A, B, chunk):
    Bt, S, H, P = x.shape
    return (x.new_empty((Bt, S // chunk, H, P, B.shape[3]), dtype=torch.float32),
            torch.empty_like(dt))


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_state)
def _(x, dt, A, B, chunk, *args, **kwargs) -> int:
    Bt, S, H, P = x
    return flops.ssd_chunk_state(Bt, S, H, P, B[3], chunk)


def ssd_state_pass(chunk_in: torch.Tensor, cum: torch.Tensor,
                   h0: torch.Tensor | None = None, *, chunk: int):
    """chunk_in: (Bt, nc, H, P, N) f32; cum: (Bt, nc * chunk, H) f32; h0:
    (Bt, H, P, N) f32 or None (zeros).

    Returns (h_ins (Bt, nc, H, P, N), h_final (Bt, H, P, N)), f32: the state
    entering each chunk and the state after the last (``pass_states``)."""
    if chunk_in.device.type == "cpu":
        return pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]), h0)
    if chunk_in.dim() != 5 or cum.dim() != 3:
        raise ValueError("chunk_in must be (Bt, nc, H, P, N), cum (Bt, S, H)")
    Bt, nc, H, P, N = chunk_in.shape
    if cum.shape != (Bt, nc * chunk, H) or not 1 <= chunk <= MAX_CHUNK \
            or nc < 1 or (P * N) % 4:
        raise ValueError(f"shapes do not match: chunk_in {tuple(chunk_in.shape)}"
                         f", cum {tuple(cum.shape)}, chunk {chunk} (1.."
                         f"{MAX_CHUNK}; P*N a multiple of 4)")
    if h0 is not None and h0.shape != (Bt, H, P, N):
        raise ValueError(f"h0 must be {(Bt, H, P, N)}, got {tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (chunk_in, cum, h0)
           if t is not None):
        raise TypeError("chunk_in, cum and h0 must be float32")
    if Bt * H * P * N // 4 > _MAX_GRID_X:
        raise ValueError(f"Bt*H*P*N/4={Bt * H * P * N // 4} exceeds the "
                         "kernel's grid")
    _check_device(chunk_in, cum, h0)
    return run(_state_pass_op, _state_pass_launch, chunk_in, cum, h0,
               chunk)


def _state_pass_launch(chunk_in: torch.Tensor, cum: torch.Tensor,
                       h0: Optional[torch.Tensor], chunk: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    Bt, nc, H, P, N = chunk_in.shape
    _check_aligned(chunk_in, cum, h0)
    h_ins = torch.empty_like(chunk_in)
    h_final = torch.empty(Bt, H, P, N, dtype=torch.float32,
                          device=chunk_in.device)
    _launch("ssd_state_pass", _function(BF16_LIBRARY, "ssd_state_pass", 5, 6),
            chunk_in.data_ptr(), cum.data_ptr(),
            None if h0 is None else h0.data_ptr(), h_ins.data_ptr(),
            h_final.data_ptr(), Bt, nc * chunk, H, P, N, chunk,
            device=chunk_in.device)
    return h_ins, h_final


_state_pass_op = torch.library.custom_op(
    "repro_torch::ssd_state_pass", mutates_args=())(_state_pass_launch)


@_state_pass_op.register_fake
def _(chunk_in, cum, h0, chunk):
    Bt, _, H, P, N = chunk_in.shape
    return (torch.empty_like(chunk_in),
            chunk_in.new_empty((Bt, H, P, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_state_pass)
def _(chunk_in, *args, **kwargs) -> int:
    return flops.ssd_state_pass(*chunk_in)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h_ins: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """x: (Bt, S, H, P) bf16; dt, cum: (Bt, S, H) f32; B, C: (Bt, S, G, N)
    bf16; D: (H,) f32; h_ins: (Bt, S/chunk, H, P, N) f32.

    Returns y (Bt, S, H, P) bf16: intra-chunk term, carry of h_ins and D
    skip, rounded once (``chunk_scan_ref``)."""
    if x.device.type == "cpu":
        return chunk_scan_ref(x, dt, cum, B, C, D, h_ins, chunk=chunk)
    _check(x, dt, cum, B, C, chunk, dtypes=(torch.bfloat16,))
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if D.shape != (H,) or h_ins.shape != (Bt, S // chunk, H, P, N):
        raise ValueError(f"D must be {(H,)} and h_ins "
                         f"{(Bt, S // chunk, H, P, N)}, got {tuple(D.shape)}, "
                         f"{tuple(h_ins.shape)}")
    if D.dtype != torch.float32 or h_ins.dtype != torch.float32:
        raise TypeError(f"D and h_ins must be float32, got {D.dtype}, "
                        f"{h_ins.dtype}")
    _check_grid(x, B, chunk, SCAN_HEAD_BLOCK)
    _check_device(x, dt, cum, B, C, D, h_ins)
    return run(_chunk_scan_op, _chunk_scan_launch, x, dt, cum, B, C, D,
               h_ins, chunk)


def _chunk_scan_launch(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       h_ins: torch.Tensor, chunk: int) -> torch.Tensor:
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    _check_aligned(x, dt, cum, B, C, D, h_ins)
    y = torch.empty_like(x)
    _launch("ssd_chunk_scan", _function(BF16_LIBRARY, "ssd_chunk_scan", 8, 8),
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), h_ins.data_ptr(), y.data_ptr(),
            Bt, S, H, G, P, N, chunk, SCAN_HEAD_BLOCK, device=x.device)
    return y


_chunk_scan_op = torch.library.custom_op(
    "repro_torch::ssd_chunk_scan", mutates_args=())(_chunk_scan_launch)


@_chunk_scan_op.register_fake
def _(x, dt, cum, B, C, D, h_ins, chunk):
    return torch.empty_like(x)


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_scan)
def _(x, dt, cum, B, C, D, h_ins, chunk, *args, **kwargs) -> int:
    Bt, S, H, P = x
    return flops.ssd_chunk_scan(Bt, S, H, P, B[2], B[3], chunk, SCAN_HEAD_BLOCK)


def ssd_bwd_dstate(dy: torch.Tensor, cum: torch.Tensor, C: torch.Tensor, *,
                   chunk: int) -> torch.Tensor:
    """dy: (Bt, S, H, P); cum: (Bt, S, H) f32; C: (Bt, S, G, N) in dy's type.

    Returns dS (Bt, S/chunk, H, P, N) f32, each chunk's gradient of its
    incoming state through the carry (``chunk_dstate_ref``): the tensor-core
    kernel for bf16 (a block per (batch * chunk, group, STATE_HEAD_BLOCK
    heads)), the CUDA-core kernel for f32 (a block per (batch * chunk,
    head))."""
    if dy.device.type == "cpu":
        return chunk_dstate_ref(dy, cum, C, chunk=chunk)
    _check(dy, cum, cum, C, C, chunk)
    Bt, S, H, P = dy.shape
    G, N = C.shape[2], C.shape[3]
    bf16 = dy.dtype == torch.bfloat16
    if bf16:
        _check_grid(dy, C, chunk, STATE_HEAD_BLOCK)
    elif Bt * (S // chunk) * H > _MAX_GRID_X:
        raise ValueError(f"{Bt * (S // chunk) * H} blocks exceed the kernel's grid")
    _check_device(dy, cum, C)
    return run(_bwd_dstate_op, _bwd_dstate_launch, dy, cum, C, chunk)


def _bwd_dstate_launch(dy: torch.Tensor, cum: torch.Tensor, C: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    Bt, S, H, P = dy.shape
    G, N = C.shape[2], C.shape[3]
    bf16 = dy.dtype == torch.bfloat16
    if bf16:
        _check_aligned(dy, cum, C)
    dS = torch.empty(Bt, S // chunk, H, P, N, dtype=torch.float32,
                     device=dy.device)
    if bf16:
        _launch("ssd_bwd_dstate",
                _function(BF16_LIBRARY, "ssd_bwd_dstate_bf16", 4, 8),
                dy.data_ptr(), cum.data_ptr(), C.data_ptr(), dS.data_ptr(), Bt,
                S, H, G, P, N, chunk, STATE_HEAD_BLOCK, device=dy.device)
    else:
        _launch("ssd_bwd_dstate", _function(BWD_LIBRARY, "ssd_bwd_dstate", 4, 8),
                dy.data_ptr(), cum.data_ptr(), C.data_ptr(), dS.data_ptr(), Bt,
                S, H, G, P, N, chunk, _DTYPES[dy.dtype], device=dy.device)
    return dS


_bwd_dstate_op = torch.library.custom_op(
    "repro_torch::ssd_bwd_dstate", mutates_args=())(_bwd_dstate_launch)


@_bwd_dstate_op.register_fake
def _(dy, cum, C, chunk):
    Bt, S, H, P = dy.shape
    return dy.new_empty((Bt, S // chunk, H, P, C.shape[3]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_bwd_dstate)
def _(dy, cum, C, chunk, *args, **kwargs) -> int:
    Bt, S, H, P = dy
    return flops.ssd_bwd_dstate(Bt, S, H, P, C[3])


def ssd_bwd_state_pass(dS: torch.Tensor, cum: torch.Tensor, h_ins: torch.Tensor,
                       dh_final: torch.Tensor | None = None, *, chunk: int):
    """dS, h_ins: (Bt, nc, H, P, N) f32; cum: (Bt, nc * chunk, H) f32;
    dh_final: (Bt, H, P, N) f32 or None (zeros).

    Returns (dchunk_in (Bt, nc, H, P, N), dh0 (Bt, H, P, N), end_term
    (Bt, nc, H)), f32: the reverse scan over the chunks
    (``state_pass_bwd_ref``); the kernel writes end_term's partial sums, one
    per block, and PyTorch adds them."""
    if dS.device.type == "cpu":
        return state_pass_bwd_ref(dS, cum, h_ins, dh_final, chunk=chunk)
    if dS.dim() != 5 or cum.dim() != 3:
        raise ValueError("dS must be (Bt, nc, H, P, N), cum (Bt, S, H)")
    Bt, nc, H, P, N = dS.shape
    if h_ins.shape != dS.shape or cum.shape != (Bt, nc * chunk, H) \
            or not 1 <= chunk <= MAX_CHUNK or (P * N) % 4:
        raise ValueError(f"shapes do not match: dS {tuple(dS.shape)}, h_ins "
                         f"{tuple(h_ins.shape)}, cum {tuple(cum.shape)}, chunk "
                         f"{chunk} (1..{MAX_CHUNK}; P*N a multiple of 4)")
    if dh_final is not None and dh_final.shape != (Bt, H, P, N):
        raise ValueError(f"dh_final must be {(Bt, H, P, N)}, got "
                         f"{tuple(dh_final.shape)}")
    if any(t.dtype != torch.float32 for t in (dS, cum, h_ins, dh_final)
           if t is not None):
        raise TypeError("dS, cum, h_ins and dh_final must be float32")
    parts = -(-(P * N // 4) // _BWD_PASS_THREADS)
    if Bt * H > _MAX_GRID_X or parts > _MAX_GRID_Y:
        raise ValueError(f"Bt*H={Bt * H}, {parts} parts exceed the kernel's grid")
    _check_device(dS, cum, h_ins, dh_final)
    return run(_bwd_state_pass_op, _bwd_state_pass_launch, dS, cum, h_ins,
               dh_final, chunk)


def _bwd_state_pass_launch(dS: torch.Tensor, cum: torch.Tensor,
                           h_ins: torch.Tensor, dh_final: Optional[torch.Tensor],
                           chunk: int
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    Bt, nc, H, P, N = dS.shape
    parts = -(-(P * N // 4) // _BWD_PASS_THREADS)
    _check_aligned(dS, cum, h_ins, dh_final)
    dchunk_in = torch.empty_like(dS)
    dh0 = torch.empty(Bt, H, P, N, dtype=torch.float32, device=dS.device)
    end_part = torch.empty(Bt, nc, H, parts, dtype=torch.float32, device=dS.device)
    _launch("ssd_bwd_state_pass",
            _function(BWD_LIBRARY, "ssd_bwd_state_pass", 7, 6),
            dS.data_ptr(), cum.data_ptr(), h_ins.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            dchunk_in.data_ptr(), dh0.data_ptr(), end_part.data_ptr(), Bt,
            nc * chunk, H, P, N, chunk, device=dS.device)
    return dchunk_in, dh0, end_part.sum(-1)


_bwd_state_pass_op = torch.library.custom_op(
    "repro_torch::ssd_bwd_state_pass", mutates_args=())(_bwd_state_pass_launch)


@_bwd_state_pass_op.register_fake
def _(dS, cum, h_ins, dh_final, chunk):
    Bt, nc, H, P, N = dS.shape
    return (torch.empty_like(dS), dS.new_empty((Bt, H, P, N)),
            dS.new_empty((Bt, nc, H)))


@register_flop_formula(torch.ops.repro_torch.ssd_bwd_state_pass)
def _(dS, *args, **kwargs) -> int:
    return flops.ssd_bwd_state_pass(*dS)


def ssd_bwd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  cum: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  D: torch.Tensor, dy: torch.Tensor, h_ins: torch.Tensor,
                  dchunk_in: torch.Tensor, end_term: torch.Tensor, *,
                  chunk: int):
    """x, dy: (Bt, S, H, P); dt, cum: (Bt, S, H) f32; A, D: (H,) f32; B, C:
    (Bt, S, G, N) in x's type; h_ins, dchunk_in: (Bt, nc, H, P, N) f32;
    end_term: (Bt, nc, H) f32.

    Returns (dx in x's dtype, ddt (Bt, S, H), dA (H,), dB, dC (Bt, S, G, N),
    dD (H,)), the rest f32 (``chunk_bwd_ref``).  bf16 launches the
    tensor-core kernel (``ssd_bwd_chunk_tc``, a block per (batch * chunk,
    group, BWD_TC_HEAD_BLOCK heads)), f32 the CUDA-core kernel
    (``ssd_bwd_chunk_cuda_cores``); each writes dB, dC, dA and dD as partial
    sums, one per head block (dB, dC) or per (batch, chunk) (dA, dD), and
    PyTorch adds them."""
    return _bwd_chunk(x.dtype == torch.bfloat16, x, dt, A, cum, B, C, D, dy,
                      h_ins, dchunk_in, end_term, chunk)


def ssd_bwd_chunk_cuda_cores(x: torch.Tensor, dt: torch.Tensor,
                             A: torch.Tensor, cum: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                             dy: torch.Tensor, h_ins: torch.Tensor,
                             dchunk_in: torch.Tensor, end_term: torch.Tensor, *,
                             chunk: int):
    """``ssd_bwd_chunk`` by ``csrc/ssd_bwd.cu``'s CUDA-core kernel (a block
    per (batch * chunk, BWD_HEAD_BLOCK heads), counted as ``ssd_bwd_chunk``)
    in either input type: ``ssd_bwd_chunk``'s f32 path, and on bf16 inputs
    the design that the tensor-core kernel replaced, which ``chip_smoke.py``
    times beside it."""
    return _bwd_chunk(False, x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in,
                      end_term, chunk)


def _bwd_chunk(tensor_cores: bool, x, dt, A, cum, B, C, D, dy, h_ins,
               dchunk_in, end_term, chunk: int):
    if x.device.type == "cpu":
        dx, *rest = chunk_bwd_ref(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in,
                                  end_term, chunk=chunk)
        return (dx.to(x.dtype), *rest)
    _check(x, dt, cum, B, C, chunk)
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = S // chunk
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if A.shape != (H,) or D.shape != (H,) or end_term.shape != (Bt, nc, H) \
            or h_ins.shape != (Bt, nc, H, P, N) or dchunk_in.shape != h_ins.shape:
        raise ValueError(f"A and D must be ({H},), end_term {(Bt, nc, H)}, h_ins "
                         f"and dchunk_in {(Bt, nc, H, P, N)}")
    if any(t.dtype != torch.float32 for t in (A, D, h_ins, dchunk_in, end_term)):
        raise TypeError("A, D, h_ins, dchunk_in and end_term must be float32")
    hb = BWD_TC_HEAD_BLOCK if tensor_cores else BWD_HEAD_BLOCK
    _check_grid(x, B, chunk, hb)
    _check_device(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end_term)
    return run(_bwd_chunk_op, _bwd_chunk_launch, tensor_cores, x, dt, A, cum,
               B, C, D, dy, h_ins, dchunk_in, end_term, chunk)


def _bwd_chunk_launch(tensor_cores: bool, x: torch.Tensor, dt: torch.Tensor,
                      A: torch.Tensor, cum: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, D: torch.Tensor, dy: torch.Tensor,
                      h_ins: torch.Tensor, dchunk_in: torch.Tensor,
                      end_term: torch.Tensor, chunk: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor, torch.Tensor]:
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = S // chunk
    hb = BWD_TC_HEAD_BLOCK if tensor_cores else BWD_HEAD_BLOCK
    if tensor_cores:
        _check_aligned(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end_term)
    nhb = -(-(H // G) // hb)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dB_part = torch.empty(nhb, Bt, S, G, N, dtype=torch.float32, device=x.device)
    # the CUDA-core kernel adds into dC_part; the tensor-core one writes it
    dC_part = torch.empty_like(dB_part) if tensor_cores \
        else torch.zeros_like(dB_part)
    dA_part = torch.empty(Bt, nc, H, dtype=torch.float32, device=x.device)
    dD_part = torch.empty_like(dA_part)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), cum.data_ptr(),
            B.data_ptr(), C.data_ptr(), D.data_ptr(), dy.data_ptr(),
            h_ins.data_ptr(), dchunk_in.data_ptr(), end_term.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
            dA_part.data_ptr(), dD_part.data_ptr())
    if tensor_cores:
        _launch(BWD_TC_KERNEL,
                _function(BWD_TC_LIBRARY, "ssd_bwd_chunk_tc", 17, 8),
                *ptrs, Bt, S, H, G, P, N, chunk, hb, device=x.device)
    else:
        _launch("ssd_bwd_chunk", _function(BWD_LIBRARY, "ssd_bwd_chunk", 17, 9),
                *ptrs, Bt, S, H, G, P, N, chunk, hb, _DTYPES[x.dtype],
                device=x.device)
    return (dx, ddt, dA_part.sum((0, 1)), dB_part.sum(0), dC_part.sum(0),
            dD_part.sum((0, 1)))


_bwd_chunk_op = torch.library.custom_op(
    "repro_torch::ssd_bwd_chunk", mutates_args=())(_bwd_chunk_launch)


@_bwd_chunk_op.register_fake
def _(tensor_cores, x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end_term,
      chunk):
    f32 = dict(dtype=torch.float32)
    return (torch.empty_like(x), torch.empty_like(dt), A.new_empty(A.shape, **f32),
            B.new_empty(B.shape, **f32), C.new_empty(C.shape, **f32),
            D.new_empty(D.shape, **f32))


@register_flop_formula(torch.ops.repro_torch.ssd_bwd_chunk)
def _(tensor_cores, x, dt, A, cum, B, *args, **kwargs) -> int:
    Bt, S, H, P = x
    return flops.ssd_bwd_chunk(Bt, S, H, P, B[2], B[3], args[-1])


def bwd_attributes(kernel: str, P: int, N: int, dtype: torch.dtype) -> dict:
    """Registers, local bytes (spills and stack) and shared bytes of a
    compiled SSD backward kernel at (P, N) and input type, by
    ``cudaFuncGetAttributes`` (for the bf16 ``ssd_bwd_dstate``, the
    tensor-core kernel at STATE_HEAD_BLOCK; ``ssd_bwd_chunk_tc``, the bf16
    ``ssd_bwd_chunk``, at BWD_TC_HEAD_BLOCK)."""
    if kernel == "ssd_bwd_dstate" and dtype == torch.bfloat16:
        return attributes(kernel, P, N)
    if kernel == BWD_TC_KERNEL:
        fn = getattr(load(BWD_TC_LIBRARY), "ssd_bwd_tc_attributes")
        args = (P, N, BWD_TC_HEAD_BLOCK)
    else:
        fn = getattr(load(BWD_LIBRARY), "ssd_bwd_attributes")
        args = (BWD_KERNELS.index(kernel), P, N, _DTYPES[dtype])
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    err = fn(*args, *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes"),
                    (v.value for v in vals)))


def attributes(kernel: str, P: int, N: int) -> dict:
    """Registers, local bytes (spills and stack) and shared bytes of the
    compiled ``ssd_chunk_state``, ``ssd_chunk_scan`` or bf16
    ``ssd_bwd_dstate`` (all in ``csrc/ssd_bf16.cu``) at (P, N) and the
    default head block, by ``cudaFuncGetAttributes``."""
    which = {"ssd_chunk_state": 0, "ssd_chunk_scan": 1, "ssd_bwd_dstate": 2}[kernel]
    fn = getattr(load(BF16_LIBRARY), "ssd_bf16_attributes")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    err = fn(which, P, N, STATE_HEAD_BLOCK, *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"ssd_bf16_attributes failed with CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes"),
                    (v.value for v in vals)))
