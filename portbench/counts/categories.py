"""Kernel groups by name: a frozen copy of ``tools/train_profile.py``'s
``category``, plus the split of the port's hand-written kernels into the
ones the roofline readers count."""
from __future__ import annotations

HAND_WRITTEN = "hand-written kernels"
MATMUL_BF16 = "matrix products, bf16"
MATMUL_F32 = "matrix products, f32"
OTHER = "everything else (elementwise, reductions, copies, indexing)"


def category(name: str) -> str:
    """The group of a device operation, from its name."""
    low = name.lower()
    if any(s in low for s in ("flash_attn", "ssd_bwd", "ssd_chunk",
                              "ssd_state_pass", "rglru_", "pack_fill")):
        return HAND_WRITTEN
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        # cuBLAS's f32 kernels name their type (f32f32, sgemm); its bf16 ones
        # may not (nvjet)
        return MATMUL_F32 if any(s in low for s in ("f32f32", "sgemm")) \
            else MATMUL_BF16
    return OTHER


def is_matmul(name: str) -> bool:
    return category(name) in (MATMUL_BF16, MATMUL_F32)


def flash_part(name: str):
    """"fwd", "bwd" (the backward's kernel that runs once a call: dK/dV),
    "bwd_other" (its other kernels) or None."""
    low = name.lower()
    if "flash_attn_fwd" in low:
        return "fwd"
    if "flash_attn_bwd_dkdv" in low:
        return "bwd"
    if "flash_attn_bwd" in low:
        return "bwd_other"
    return None


def ssd_part(name: str):
    """"fwd" (the forward's last kernel, once a call: the chunk scan),
    "fwd_other", "bwd" (the backward's chunk kernel, once a call),
    "bwd_other" or None."""
    low = name.lower()
    if "ssd_bwd_chunk" in low:
        return "bwd"
    if "ssd_bwd" in low:
        return "bwd_other"
    if "ssd_chunk_scan" in low or low.startswith("ssd_chunk_kernel") \
            or "ssd_chunk_kernel" in low:
        return "fwd"
    if "ssd_chunk" in low or "ssd_state_pass" in low:
        return "fwd_other"
    return None
