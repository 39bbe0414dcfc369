"""ctypes wrappers of the CUDA RG-LRU scan kernels (``csrc/rglru_scan.cu``):
``rglru_scan_fwd``, the port of ``rglru_scan_pallas``, and
``rglru_scan_bwd``, its gradient (no TPU counterpart: the JAX package
differentiates its jnp scan).

On a CPU tensor each wrapper computes its kernel's plain version
(``ref.rglru_scan_ref``, ``ref.rglru_scan_bwd_ref``); on a CUDA tensor it
launches the kernel, counting the launch under its own name, or raises.  The
launches are registered as custom ops (``repro_torch::rglru_scan``,
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
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

NAME = "rglru_scan"
BWD_NAME = "rglru_scan_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 64  # channels per block, as in the .cu file
_MAX_GRID_Y = 65535


def _function(name: str = NAME, n_ptr: int = 6):
    fn = getattr(load(NAME), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, args, device) -> None:
    fn = _function(name, len(args) - 4)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    count_launch(name)


def _check(a, u, h0, u_name: str = "u"):
    if a.dim() != 3 or a.shape != u.shape:
        raise ValueError(f"a {tuple(a.shape)} and {u_name} {tuple(u.shape)} "
                         "must be (B, S, R), the same shape")
    B, S, R = a.shape
    if B < 1 or S < 1 or R < 1:
        raise ValueError(f"bad sizes: B={B} S={S} R={R}")
    if a.dtype not in _DTYPES or u.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {u.dtype}: the kernel takes "
                        f"float32 or bfloat16, the same for a and {u_name}")
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
    if B > _MAX_GRID_Y or -(-R // _THREADS) >= 2 ** 31:
        raise ValueError(f"B={B}, R={R} exceed the kernel's grid")


def rglru_scan_fwd(a: torch.Tensor, u: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   return_state: bool = False):
    """a, u: (B, S, R); h0: (B, R) f32 or None (zeros).

    Returns (h_seq (B, S, R) in u's dtype, h_final (B, R) f32), and with
    ``return_state`` also every state in f32 (h_seq itself when u is f32),
    which the backward reads."""
    if a.device.type == "cpu":
        hs, h_final = rglru_scan_ref(a, u, h0)
        if not return_state:
            return hs, h_final
        # h_seq itself in f32; else the same loop on the f32 values of a, u
        h_state = hs if hs.dtype == torch.float32 \
            else rglru_scan_ref(a.float(), u.float(), h0)[0]
        return hs, h_final, h_state
    _check(a, u, h0)
    hs, h_final, h_state = run(_scan_op, _scan_launch, a, u, h0,
                               return_state)
    if not return_state:
        return hs, h_final
    return hs, h_final, hs if hs.dtype == torch.float32 else h_state


def _scan_launch(a: torch.Tensor, u: torch.Tensor, h0: Optional[torch.Tensor],
                 return_state: bool) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Launches the scan; the third output holds every state in f32 for a
    bf16 u with ``return_state`` (an f32 h_seq is its own), else is empty."""
    B, S, R = a.shape
    hs = torch.empty_like(u)
    h_final = torch.empty(B, R, dtype=torch.float32, device=a.device)
    separate = return_state and hs.dtype != torch.float32
    h_state = torch.empty((B, S, R) if separate else (0,), dtype=torch.float32,
                          device=a.device)
    _launch(NAME, (a.data_ptr(), u.data_ptr(), _ptr(h0), hs.data_ptr(),
                   h_final.data_ptr(), h_state.data_ptr() if separate else None,
                   B, S, R, _DTYPES[a.dtype]), a.device)
    return hs, h_final, h_state


_scan_op = torch.library.custom_op(
    "repro_torch::rglru_scan", mutates_args=())(_scan_launch)


@_scan_op.register_fake
def _(a, u, h0, return_state):
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
                   dh_final: Optional[torch.Tensor] = None):
    """The gradient of ``rglru_scan_fwd`` from its f32 states.

    a, dh_seq: (B, S, R), one type (f32 or bf16); h_state: (B, S, R) f32;
    h0, dh_final: (B, R) f32 or None (zeros).  Returns (da, du) in a's dtype
    and dh0 (B, R) f32."""
    if a.device.type == "cpu":
        first = torch.zeros_like(h_state[:, :1]) if h0 is None \
            else h0.float()[:, None]
        h_prev = torch.cat([first, h_state[:, :-1]], dim=1)
        return rglru_scan_bwd_ref(a, h_prev, dh_seq, dh_final)
    if h_state.shape != a.shape or h_state.dtype != torch.float32:
        raise ValueError(f"h_state {tuple(h_state.shape)} {h_state.dtype} must "
                         f"be {tuple(a.shape)} float32")
    if dh_final is not None and (dh_final.shape != (a.shape[0], a.shape[-1])
                                 or dh_final.dtype != torch.float32):
        raise ValueError(f"dh_final {tuple(dh_final.shape)} {dh_final.dtype} "
                         "must be (B, R) float32")
    _check(a, dh_seq, h0, "dh_seq")
    tensors = [t for t in (h_state, dh_final) if t is not None]
    if any(t.device != a.device or not t.is_contiguous() for t in tensors):
        raise ValueError("h_state and dh_final must be contiguous, on a's device")
    return run(_bwd_op, _bwd_launch, a, h_state, h0, dh_seq, dh_final)


def _bwd_launch(a: torch.Tensor, h_state: torch.Tensor, h0: Optional[torch.Tensor],
                dh_seq: torch.Tensor, dh_final: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, R = a.shape
    da, du = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty(B, R, dtype=torch.float32, device=a.device)
    _launch(BWD_NAME, (a.data_ptr(), h_state.data_ptr(), _ptr(h0),
                       dh_seq.data_ptr(), _ptr(dh_final), da.data_ptr(),
                       du.data_ptr(), dh0.data_ptr(), B, S, R, _DTYPES[a.dtype]),
            a.device)
    return da, du, dh0


_bwd_op = torch.library.custom_op(
    "repro_torch::rglru_scan_bwd", mutates_args=())(_bwd_launch)


@_bwd_op.register_fake
def _(a, h_state, h0, dh_seq, dh_final):
    B, _, R = a.shape
    return (torch.empty_like(a), torch.empty_like(a),
            a.new_empty((B, R), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _(a_shape, *args, **kwargs) -> int:
    return flops.rglru_scan_bwd(*a_shape)
