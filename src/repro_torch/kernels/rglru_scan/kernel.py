"""ctypes wrappers of the CUDA RG-LRU scan kernels (``csrc/rglru_scan.cu``):
``rglru_scan_fwd``, the port of ``rglru_scan_pallas``, and
``rglru_scan_bwd``, its gradient (no TPU counterpart: the JAX package
differentiates its jnp scan).

Both scan the sequence in chunks of ``chunk_length(B, S, R)`` steps (or a
``chunk`` the caller gives): a summary kernel, then the scan kernel, two CUDA
launches in stream order, counted as one launch of the wrapper; one chunk,
and the scan kernel alone, where S <= chunk.  On a CPU tensor each wrapper
computes its kernels' plain mirror with the same chunk
(``ref.rglru_scan_chunked_ref``, ``ref.rglru_scan_bwd_chunked_ref``), so the
CPU and the card give the same bits; on a CUDA tensor it launches the
kernels, counting the launch under its own name, or raises.  The launches
are registered as custom ops (``repro_torch::rglru_scan``,
``rglru_scan_bwd``) that a fake tensor goes through (``kernels.run``): shapes
alone, and a multiply and an add an element and step (``kernels.flops``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import count_launch, flops, run
from ..build import load
from .ref import rglru_scan_bwd_chunked_ref, rglru_scan_chunked_ref

NAME = "rglru_scan"
BWD_NAME = "rglru_scan_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 64  # channels per block, as in the .cu file
UNROLL = 16  # steps a thread loads ahead, as in the .cu file
_MAX_GRID_YZ = 65535
# The chunk rule, from tools/rglru_compare.py's sweep at S 2048, R 2560, f32
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).  From FULL_CHAINS chains
# (B x R) on, one chunk a chain fills the card and a second pass only adds
# bytes (B 4, 10,240 chains: C = 1 beat every chunk length, 0.1470 ms against
# 0.1488 and more); below, the scan takes TARGET_THREADS // (B x R) chunks,
# one wave of the chunked scan kernels (123-128 registers: 512 threads an SM,
# 132 SMs), which was the fastest at B 1, 2 and 3 (80-, 160- and 256-step
# chunks).  MIN_CHUNK bounds the composition (at most S / MIN_CHUNK reads a
# thread) for small B x R.
FULL_CHAINS = 8192
TARGET_THREADS = 132 * 512
MIN_CHUNK = 64


def chunk_length(B: int, S: int, R: int) -> int:
    """The chunk the wrappers scan in, a multiple of ``UNROLL``; at least
    S (one chunk) where B x R chains fill the card."""
    chains = B * R
    if chains >= FULL_CHAINS:
        return n_chunks(S, UNROLL) * UNROLL
    per_chunk = n_chunks(S, max(1, TARGET_THREADS // chains))
    return max(MIN_CHUNK, n_chunks(per_chunk, UNROLL) * UNROLL)


def n_chunks(S: int, chunk: int) -> int:
    """ceil(S / chunk)."""
    return -(-S // chunk)


def _function(name: str = NAME, n_ptr: int = 7):
    fn = getattr(load(NAME), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_launches() -> int:
    """The CUDA kernels the library's entries have launched since it was
    loaded (builds it if needed): 2 a wrapper call that scans in more than
    one chunk, else 1.  ``LAUNCHES`` counts the wrapper calls."""
    fn = load(NAME).rglru_scan_kernel_launches
    fn.argtypes, fn.restype = [], ctypes.c_ulonglong
    return int(fn())


def _launch(name: str, args, device) -> None:
    fn = _function(name, len(args) - 5)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    count_launch(name)


def _check(a, u, h0, chunk: int, u_name: str = "u"):
    if a.dim() != 3 or a.shape != u.shape:
        raise ValueError(f"a {tuple(a.shape)} and {u_name} {tuple(u.shape)} "
                         "must be (B, S, R), the same shape")
    B, S, R = a.shape
    if B < 1 or S < 1 or R < 1:
        raise ValueError(f"bad sizes: B={B} S={S} R={R}")
    if a.dtype not in _DTYPES or u.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {u.dtype}: the kernel takes "
                        f"float32 or bfloat16, the same for a and {u_name}")
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be at least 1")
    C = n_chunks(S, chunk)
    if B > _MAX_GRID_YZ or C > _MAX_GRID_YZ or -(-R // _THREADS) >= 2 ** 31:
        raise ValueError(f"B={B}, R={R} and {C} chunks of {chunk} exceed the "
                         "kernels' grid")
    tensors = (a, u) if h0 is None else (a, u, h0)
    if h0 is not None:
        if h0.shape != (B, R):
            raise ValueError(f"h0 {tuple(h0.shape)} must be (B, R) = ({B}, {R})")
        if h0.dtype != torch.float32:
            raise TypeError(f"h0 must be float32, got {h0.dtype}")
    if len({t.device for t in tensors}) != 1 or a.device.type != "cuda":
        raise ValueError(f"a, {u_name} and h0 must lie on one CUDA device: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"a, {u_name} and h0 must be contiguous")


def rglru_scan_fwd(a: torch.Tensor, u: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   return_state: bool = False, chunk: Optional[int] = None):
    """a, u: (B, S, R); h0: (B, R) f32 or None (zeros).

    Returns (h_seq (B, S, R) in u's dtype, h_final (B, R) f32), and with
    ``return_state`` also every state in f32 (h_seq itself when u is f32),
    which the backward reads.  ``chunk``: the steps a chunk, by default
    ``chunk_length(B, S, R)``."""
    if chunk is None and a.dim() == 3:
        chunk = chunk_length(*a.shape)
    if a.device.type == "cpu":
        hs, h_final = rglru_scan_chunked_ref(a, u, h0, chunk)
        if not return_state:
            return hs, h_final
        # h_seq itself in f32; else the same scan of the f32 values of a, u
        h_state = hs if hs.dtype == torch.float32 \
            else rglru_scan_chunked_ref(a.float(), u.float(), h0, chunk)[0]
        return hs, h_final, h_state
    _check(a, u, h0, chunk)
    hs, h_final, h_state = run(_scan_op, _scan_launch, a, u, h0,
                               return_state, min(chunk, a.shape[1]))
    if not return_state:
        return hs, h_final
    return hs, h_final, hs if hs.dtype == torch.float32 else h_state


def _workspace(a: torch.Tensor, chunk: int) -> Optional[torch.Tensor]:
    """The chunk summaries, (2, B, C, R) f32, where there are C > 1 chunks."""
    B, S, R = a.shape
    C = n_chunks(S, chunk)
    return None if C == 1 else torch.empty(2, B, C, R, dtype=torch.float32,
                                           device=a.device)


def _scan_launch(a: torch.Tensor, u: torch.Tensor, h0: Optional[torch.Tensor],
                 return_state: bool, chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launches the scan; the third output holds every state in f32 for a
    bf16 u with ``return_state`` (an f32 h_seq is its own), else is empty."""
    B, S, R = a.shape
    hs = torch.empty_like(u)
    h_final = torch.empty(B, R, dtype=torch.float32, device=a.device)
    separate = return_state and hs.dtype != torch.float32
    h_state = torch.empty((B, S, R) if separate else (0,), dtype=torch.float32,
                          device=a.device)
    ws = _workspace(a, chunk)
    _launch(NAME, (a.data_ptr(), u.data_ptr(), _ptr(h0), hs.data_ptr(),
                   h_final.data_ptr(), h_state.data_ptr() if separate else None,
                   _ptr(ws), B, S, R, chunk, _DTYPES[a.dtype]), a.device)
    return hs, h_final, h_state


_scan_op = torch.library.custom_op(
    "repro_torch::rglru_scan", mutates_args=())(_scan_launch)


@_scan_op.register_fake
def _(a, u, h0, return_state, chunk):
    B, S, R = a.shape
    separate = return_state and u.dtype != torch.float32
    return (torch.empty_like(u), a.new_empty((B, R), dtype=torch.float32),
            a.new_empty((B, S, R) if separate else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _(a_shape, *args, **kwargs) -> int:
    return flops.rglru_scan(*a_shape)


def _ptr(t):
    return None if t is None else t.data_ptr()


def rglru_scan_bwd(a: torch.Tensor, h_state: torch.Tensor,
                   h0: Optional[torch.Tensor], dh_seq: torch.Tensor,
                   dh_final: Optional[torch.Tensor] = None, *,
                   chunk: Optional[int] = None):
    """The gradient of ``rglru_scan_fwd`` from its f32 states.

    a, dh_seq: (B, S, R), one type (f32 or bf16); h_state: (B, S, R) f32;
    h0, dh_final: (B, R) f32 or None (zeros).  Returns (da, du) in a's dtype
    and dh0 (B, R) f32.  ``chunk``: the steps a chunk, by default
    ``chunk_length(B, S, R)``."""
    if chunk is None and a.dim() == 3:
        chunk = chunk_length(*a.shape)
    if a.device.type == "cpu":
        first = torch.zeros_like(h_state[:, :1]) if h0 is None \
            else h0.float()[:, None]
        h_prev = torch.cat([first, h_state[:, :-1]], dim=1)
        return rglru_scan_bwd_chunked_ref(a, h_prev, dh_seq, dh_final, chunk)
    if h_state.shape != a.shape or h_state.dtype != torch.float32:
        raise ValueError(f"h_state {tuple(h_state.shape)} {h_state.dtype} must "
                         f"be {tuple(a.shape)} float32")
    if dh_final is not None and (dh_final.shape != (a.shape[0], a.shape[-1])
                                 or dh_final.dtype != torch.float32):
        raise ValueError(f"dh_final {tuple(dh_final.shape)} {dh_final.dtype} "
                         "must be (B, R) float32")
    _check(a, dh_seq, h0, chunk, "dh_seq")
    tensors = [t for t in (h_state, dh_final) if t is not None]
    if any(t.device != a.device or not t.is_contiguous() for t in tensors):
        raise ValueError("h_state and dh_final must be contiguous, on a's device")
    return run(_bwd_op, _bwd_launch, a, h_state, h0, dh_seq, dh_final,
               min(chunk, a.shape[1]))


def _bwd_launch(a: torch.Tensor, h_state: torch.Tensor, h0: Optional[torch.Tensor],
                dh_seq: torch.Tensor, dh_final: Optional[torch.Tensor], chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, R = a.shape
    da, du = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty(B, R, dtype=torch.float32, device=a.device)
    ws = _workspace(a, chunk)
    _launch(BWD_NAME, (a.data_ptr(), h_state.data_ptr(), _ptr(h0),
                       dh_seq.data_ptr(), _ptr(dh_final), _ptr(ws), da.data_ptr(),
                       du.data_ptr(), dh0.data_ptr(), B, S, R, chunk,
                       _DTYPES[a.dtype]), a.device)
    return da, du, dh0


_bwd_op = torch.library.custom_op(
    "repro_torch::rglru_scan_bwd", mutates_args=())(_bwd_launch)


@_bwd_op.register_fake
def _(a, h_state, h0, dh_seq, dh_final, chunk):
    B, _, R = a.shape
    return (torch.empty_like(a), torch.empty_like(a),
            a.new_empty((B, R), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _(a_shape, *args, **kwargs) -> int:
    return flops.rglru_scan_bwd(*a_shape)
