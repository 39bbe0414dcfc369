"""ctypes wrappers of the CUDA flash-attention kernels.

``flash_attention_fwd`` launches ``csrc/flash_attn_fwd.cu``, the port of
``flash_attention_pallas``: bf16 inputs run the tensor-core kernel, f32
inputs the CUDA-core kernel; with ``return_lse`` it also returns each row's
log-sum-exp for the backward.  ``flash_attention_bwd`` launches the three
kernels of ``csrc/flash_attn_bwd.cu`` (D, then dK/dV, then dQ; bf16 at
``TC_BWD_HEAD_DIMS`` on the tensor cores: at ``WG_BWD_HEAD_DIMS`` the
warpgroup (wgmma) kernels, the rest on the CUDA cores), which have no TPU
counterpart: they are the gradient of the forward.  At
``WIDE_BWD_HEAD_DIMS`` the dK/dV kernel cuts each key tile's walk over the
query tiles into ``bwd_splits`` parts, one block each, and the wrapper sums
their f32 partials in PyTorch.

On a CPU tensor each wrapper computes its plain version (``ref.py``); on a
CUDA tensor it launches its kernels or raises.  The launches are registered
as custom ops (``repro_torch::flash_attn_fwd``, ``flash_attn_bwd``): a fake
tensor goes through the op, whose fake implementation gives the outputs'
shapes alone and whose flop formula (``kernels.flops``) counts the tiles the
kernels compute (``kernels.run``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import count_launch, flops, run
from ..build import load
from .ref import attention_bwd_ref, attention_ref, lse_ref

NAME = "flash_attn_fwd"
BWD_SOURCE = "flash_attn_bwd"
# head_dims at which bf16 runs the backward's tensor-core kernels; the rest,
# and f32, run its CUDA-core kernels.  At WG_BWD_HEAD_DIMS they are the
# warpgroup kernels (flash_attn_bwd_{dkdv,dq}_wg_kernel: wgmma, a warpgroup
# of 64 keys or queries a block), at WIDE_BWD_HEAD_DIMS the eight-warp
# mma.sync kernels whose dK/dV kernel splits the query walk.
TC_BWD_HEAD_DIMS = (16, 64, 256)
WG_BWD_HEAD_DIMS = (16, 64)
WIDE_BWD_HEAD_DIMS = (256,)
# The most parts bwd_splits cuts a key tile's query walk into: at
# recurrentgemma-2b's batch 1 (32 key tiles) dK/dV took 1.42-1.44 ms unsplit,
# 0.217-0.221 at 8 parts and more at 9 and 10; at batch 4 2 parts were the
# fastest (tools/flash_bwd_splits.py on an NVIDIA H100 80GB HBM3, 700 W).
MAX_BWD_SPLITS = 8
# the backward's kernels, in launch order, each with its own launch count
BWD_KERNELS = ("flash_attn_bwd_pre", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq")
# 16 is the reduced configs', 64 qwen3-0.6b's, 256 recurrentgemma-2b's
HEAD_DIMS = (16, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _block_q(hd: int, dtype: torch.dtype) -> int:
    """Query rows per block, as in the .cu file: the tensor-core kernel's
    (bf16) or the CUDA-core kernel's (f32)."""
    if dtype == torch.bfloat16:
        return 128 if hd in (64, 256) else 64
    return {128: 32, 256: 16}.get(hd, 64)


def _bwd_block(hd: int, dtype: torch.dtype) -> int:
    """Query rows and keys per tile of the backward's kernels, as in the .cu
    file: 64, but 32 in the CUDA-core kernels at hd 256."""
    return 32 if hd == 256 and dtype != torch.bfloat16 else 64


def bwd_splits(B: int, S: int, H: int, KH: int, hd: int, dtype: torch.dtype,
               sms: int) -> int:
    """Parts into which the dK/dV kernel cuts each key tile's walk over the
    (query head, query tile) pairs that see it, one block each: 1 but at
    bf16 ``WIDE_BWD_HEAD_DIMS``, whose kernel holds one block of 256
    threads an SM.  There the grid has B * KH * ceil(S / 64) blocks before
    the split (32 at recurrentgemma-2b's batch 1, for 132 SMs), and the
    split aims at two blocks an SM, the nearest whole number of parts, at
    most ``MAX_BWD_SPLITS`` and at most the walk of the longest key tile,
    (H / KH) * ceil(S / 64) pairs."""
    if dtype != torch.bfloat16 or hd not in WIDE_BWD_HEAD_DIMS:
        return 1
    tiles = -(-S // 64)
    blocks = B * KH * tiles
    return max(1, min(MAX_BWD_SPLITS, H // KH * tiles,
                      (2 * sms + blocks // 2) // blocks))


def _function():
    fn = load(NAME).flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attributes(hd: int, dtype: torch.dtype) -> dict:
    """Registers a thread, local bytes a thread (spills and stack) and shared
    bytes a block of the compiled kernel that (hd, dtype) launches; builds
    it first if need be."""
    fn = load(NAME).flash_attn_fwd_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(hd, _DTYPES[dtype], *(ctypes.byref(x) for x in out))
    if err:
        raise RuntimeError(f"{NAME} attributes failed with CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes"),
                    (x.value for x in out)))


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: q (B, S, H, hd), k/v (B, S, KH, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}: the kernel takes self-attention, Sq == Sk")
    KH = k.shape[2]
    if B < 1 or S < 1 or KH < 1 or H % KH:
        raise ValueError(f"bad head counts or sizes: B={B} S={S} H={H} KH={KH}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel; it takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes "
                        "float32 or bfloat16, the same for q, k and v")
    if -(-S // _block_q(hd, q.dtype)) > _MAX_GRID_Y or B * H >= 2 ** 31:
        raise ValueError(f"S={S}, B*H={B * H} exceed the kernel's grid")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q, k, v must lie on one CUDA device: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        return_lse: bool = False):
    """q: (B, S, H, hd); k/v: (B, S, KH, hd) -> (B, S, H, hd) in q's dtype;
    with ``return_lse`` also each row's log-sum-exp of its scaled scores,
    (B, H, S) f32."""
    if q.device.type == "cpu":
        o = attention_ref(q, k, v, causal=causal, window=window)
        if return_lse:
            return o, lse_ref(q, k, causal=causal, window=window)
        return o
    _check(q, k, v, window)
    o, lse = run(_fwd_op, _fwd_launch, q, k, v, causal, window or 0,
                 return_lse)
    return (o, lse) if return_lse else o


def _fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                window: int, return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launches the forward kernel; lse is empty unless ``return_lse``."""
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S) if return_lse else (0,), dtype=torch.float32,
                      device=q.device)
    fn = _function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 B, S, H, k.shape[2], hd, _DTYPES[q.dtype], 1.0 / hd ** 0.5,
                 int(causal), window or 0, stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {err}")
    count_launch(NAME)
    return o, lse


_fwd_op = torch.library.custom_op(
    "repro_torch::flash_attn_fwd", mutates_args=())(_fwd_launch)


@_fwd_op.register_fake
def _(q, k, v, causal, window, return_lse):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S) if return_lse else (0,),
                                            dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attn_fwd, get_raw=True)
def _(q, k, v, causal, window, return_lse, *args, **kwargs) -> int:
    B, S, H, hd = q.shape
    bn = 64 if q.dtype == torch.bfloat16 or hd <= 64 else 4096 // hd
    return flops.flash_fwd(B, S, H, hd, causal, window or None,
                           _block_q(hd, q.dtype), bn)


def _bwd_functions():
    lib = load(BWD_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    pre = lib.flash_attn_bwd_pre
    pre.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
    dkdv = lib.flash_attn_bwd_dkdv
    dkdv.argtypes = [ptr] * 10 + [i32] * 6 + [ctypes.c_float, i32, i32, i32, ptr]
    dq = lib.flash_attn_bwd_dq
    dq.argtypes = [ptr] * 7 + [i32] * 6 + [ctypes.c_float, i32, i32, ptr]
    for fn in (pre, dkdv, dq):
        fn.restype = ctypes.c_int
    return dict(zip(BWD_KERNELS, (pre, dkdv, dq)))


def bwd_attributes(name: str, hd: int, dtype: torch.dtype) -> dict:
    """Registers a thread, local bytes a thread and shared bytes a block of
    backward kernel ``name`` (one of ``BWD_KERNELS``) at (hd, dtype)."""
    fn = load(BWD_SOURCE).flash_attn_bwd_attributes
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(BWD_KERNELS.index(name), hd, _DTYPES[dtype],
             *(ctypes.byref(x) for x in out))
    if err:
        raise RuntimeError(f"{name} attributes failed with CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes"),
                    (x.value for x in out)))


def _check_bwd(q, k, v, o, lse, do, window):
    if q.dim() != 4:
        raise ValueError("q must be 4-d: (B, S, H, hd)")
    B, S, H, hd = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must match q "
                             f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected "
                         f"{(B, H, S)} float32 from the forward")
    _check(q, k, v, window)
    if -(-S // _bwd_block(hd, q.dtype)) > _MAX_GRID_Y:
        raise ValueError(f"S={S} exceeds the backward kernels' grid")
    tensors = (q, k, v, o, lse, do)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v, o, lse and do must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("o, lse and do must be contiguous")


def bwd_buffers(q, k, v, o, lse, do, *, window: Optional[int] = None,
                splits: Optional[int] = None) -> dict:
    """Checks the backward's inputs and allocates its scratch D and outputs:
    the tensors ``launch_bwd`` takes, by name.  ``splits`` (default
    ``bwd_splits`` on q's card) is the dK/dV kernel's; with more than one
    part, the f32 partials dk_part and dv_part, (splits, B, S, KH, hd) each,
    are allocated too."""
    _check_bwd(q, k, v, o, lse, do, window)
    if any(t.data_ptr() % 16 for t in (q, k, v, o, lse, do)):
        raise ValueError("the backward kernels read 16-byte aligned rows")
    B, S, H, hd = q.shape
    KH = k.shape[2]
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = bwd_splits(B, S, H, KH, hd, q.dtype, sms)
    elif splits != 1 and (q.dtype != torch.bfloat16 or splits < 1
                          or hd not in WIDE_BWD_HEAD_DIMS):
        raise ValueError(f"splits={splits}: only bf16 at head_dim "
                         f"{WIDE_BWD_HEAD_DIMS} splits the dK/dV kernel")
    bufs = {"q": q, "k": k, "v": v, "o": o, "lse": lse, "do": do,
            "delta": torch.empty((B, H, S), dtype=torch.float32, device=q.device),
            "dq": torch.empty_like(q), "dk": torch.empty_like(k),
            "dv": torch.empty_like(v), "splits": splits, "dk_part": None,
            "dv_part": None}
    if splits > 1:
        for name in ("dk_part", "dv_part"):
            bufs[name] = torch.empty((splits, *k.shape), dtype=torch.float32,
                                     device=q.device)
    return bufs


_BWD_ARGS = {  # each kernel's tensors, in its C signature's order
    "flash_attn_bwd_pre": ("o", "do", "delta"),
    "flash_attn_bwd_dkdv": ("q", "k", "v", "do", "lse", "delta", "dk", "dv",
                            "dk_part", "dv_part"),
    "flash_attn_bwd_dq": ("q", "k", "v", "do", "lse", "delta", "dq"),
}


def launch_bwd(name: str, bufs: dict, *, causal: bool,
               window: Optional[int]) -> None:
    """Launches backward kernel ``name`` on ``bufs`` (from ``bwd_buffers``)
    and counts it; ``flash_attention_bwd`` launches the three in order.
    dK/dV split into parts ends with the sum of its partials over the parts
    (one fixed-order PyTorch sum a tensor, rounded once to bf16)."""
    q = bufs["q"]
    B, S, H, hd = q.shape
    ints = (B, S, H, hd) if name == "flash_attn_bwd_pre" else (
        B, S, H, bufs["k"].shape[2], hd)
    tail = () if name == "flash_attn_bwd_pre" else (
        1.0 / hd ** 0.5, int(causal), window or 0)
    if name == "flash_attn_bwd_dkdv":
        tail += (bufs["splits"],)
    fn = _bwd_functions()[name]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(None if bufs[t] is None else bufs[t].data_ptr()
                   for t in _BWD_ARGS[name]), *ints, _DTYPES[q.dtype], *tail,
                 stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    count_launch(name)
    if name == "flash_attn_bwd_dkdv" and bufs["splits"] > 1:
        bufs["dk"].copy_(bufs["dk_part"].sum(0))
        bufs["dv"].copy_(bufs["dv_part"].sum(0))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None):
    """The gradient of ``flash_attention_fwd`` from its output ``o`` and
    log-sum-exp ``lse``: (dq (B, S, H, hd), dk, dv (B, S, KH, hd)) in q's
    dtype.  Launches ``BWD_KERNELS`` in order, one count each."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    _check_bwd(q, k, v, o, lse, do, window)
    return run(_bwd_op, _bwd_launch, q, k, v, o, lse, do, causal,
               window or 0)


def _bwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                lse: torch.Tensor, do: torch.Tensor, causal: bool, window: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    window = window or None
    bufs = bwd_buffers(q, k, v, o, lse, do, window=window)
    for name in BWD_KERNELS:
        launch_bwd(name, bufs, causal=causal, window=window)
    return bufs["dq"], bufs["dk"], bufs["dv"]


_bwd_op = torch.library.custom_op(
    "repro_torch::flash_attn_bwd", mutates_args=())(_bwd_launch)


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attn_bwd, get_raw=True)
def _(q, k, v, o, lse, do, causal, window, *args, **kwargs) -> int:
    B, S, H, hd = q.shape
    return flops.flash_bwd(B, S, H, hd, causal, window or None,
                           _bwd_block(hd, q.dtype))
