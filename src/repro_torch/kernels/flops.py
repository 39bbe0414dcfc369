"""Floating-point operations of the kernels' custom ops, the formulas that
``torch.utils.flop_counter.register_flop_formula`` gives them (each kernel's
``kernel.py`` registers its own), so that a ``FlopCounterMode`` or
``launch.trace_analysis`` counts a kernel's work as it counts a matmul's.

Attention counts the tiles the kernels compute: each query tile walks the
key tiles from its window's first to the diagonal (``flash_attn_fwd.cu``,
``flash_attn_bwd.cu``: ``k_begin``, ``k_end``), a whole tile of products
each.  The SSD counts the products of each kernel once (the hi + lo split
of the bf16 kernels, which doubles three of them, is not counted), the
RG-LRU scan a multiply and an add an element and step.
"""
from __future__ import annotations

from typing import Optional


def attention_tiles(S: int, causal: bool, window: Optional[int], bm: int,
                    bn: int) -> int:
    """(query tile, key tile) pairs a (batch, head) computes: query tiles
    of ``bm`` rows, key tiles of ``bn`` keys from the window's first tile
    to the diagonal's."""
    tiles = 0
    for q0 in range(0, S, bm):
        k_begin, k_end = 0, S
        if causal:
            k_end = min(S, q0 + bm)
        if window:
            k_begin = max(0, q0 - window + 1) // bn * bn
        tiles += -(-(k_end - k_begin) // bn)
    return tiles


def flash_fwd(B: int, S: int, H: int, hd: int, causal: bool,
              window: Optional[int], bm: int, bn: int) -> int:
    """Q.K^T and P.V over every computed tile."""
    return 4 * hd * bm * bn * B * H * attention_tiles(S, causal, window, bm, bn)


def flash_bwd(B: int, S: int, H: int, hd: int, causal: bool,
              window: Optional[int], bm: int) -> int:
    """D = rowsum(dO o O); dK/dV: S, dP, P^T.dO and dS^T.Q; dQ: S, dP and
    dS.K, over every computed tile (square tiles of ``bm``)."""
    tiles = attention_tiles(S, causal, window, bm, bm)
    return 2 * B * S * H * hd + 14 * hd * bm * bm * B * H * tiles


def _causal(Q: int) -> int:
    return Q * (Q + 1) // 2  # (q, k) pairs a chunk keeps


def ssd_chunk(Bt: int, S: int, H: int, P: int, G: int, N: int, Q: int) -> int:
    """The f32 intra-chunk kernel: C.B^T and the scores . x per head, and
    each chunk's (x w)^T . B."""
    nc = S // Q
    return Bt * H * nc * (_causal(Q) * (2 * N + 2 * P) + 2 * Q * P * N)


def ssd_chunk_state(Bt: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    return 2 * Bt * S * H * P * N  # (x w)^T . B, Q P N a (chunk, head)


def ssd_state_pass(Bt: int, nc: int, H: int, P: int, N: int) -> int:
    return 2 * Bt * nc * H * P * N  # h = decay h + chunk_in


def ssd_chunk_scan(Bt: int, S: int, H: int, P: int, G: int, N: int, Q: int,
                   head_block: int) -> int:
    """C.B^T once a (chunk, group, head block), the scores . x and
    C . h_in a head."""
    nc = S // Q
    blocks = G * -(-(H // G) // head_block)
    return Bt * nc * (blocks * _causal(Q) * 2 * N
                      + H * (_causal(Q) * 2 * P + 2 * Q * N * P))


def ssd_bwd_dstate(Bt: int, S: int, H: int, P: int, N: int) -> int:
    return 2 * Bt * S * H * P * N


def ssd_bwd_state_pass(Bt: int, nc: int, H: int, P: int, N: int) -> int:
    return 4 * Bt * nc * H * P * N


def ssd_bwd_chunk(Bt: int, S: int, H: int, P: int, G: int, N: int,
                  Q: int) -> int:
    """Per (batch, head, chunk) the causal dy.x^T and T^T.dy and
    B.dchunk_in^T, x.dchunk_in and dy.h_in; per (batch, group, chunk)
    C.B^T, dCB.B and dCB^T.C."""
    nc = S // Q
    return (2 * Bt * nc * H * (2 * _causal(Q) * P + 3 * Q * P * N)
            + 2 * Bt * nc * G * 3 * _causal(Q) * N)


def rglru_scan(B: int, S: int, R: int) -> int:
    return 2 * B * S * R  # h = a h + u


def rglru_scan_bwd(B: int, S: int, R: int) -> int:
    return 4 * B * S * R  # dh = dh_seq + a' dh', da = dh h_prev
