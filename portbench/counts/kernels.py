"""The work a kernel's call needs at its shape: operations and bytes of the
algorithm, not of an implementation.

A bound is the larger of operations over the peak FLOP/s and bytes over the
peak bandwidth (``peaks.py``).  Operations are the products the algorithm
needs: causal attention's lower triangle with its diagonal (S (S + 1) / 2
pairs), never whole tiles.  Bytes are each input read once and each output
written once, at the types of the call's interface; intermediates that an
implementation keeps between its kernels are not counted.  So a kernel that
skips tiles, recomputes less or splits differently reads the same bound."""
from __future__ import annotations

from .peaks import HBM_BW, PEAK_FLOPS

BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work, in seconds."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def _pairs(S: int) -> int:
    return S * (S + 1) // 2  # causal (query, key) pairs of a row


def flash_fwd(B: int, S: int, H: int, KH: int, hd: int, *,
              lse: bool) -> tuple:
    """(flops, bytes) of causal attention's forward: Q K^T and P V over the
    causal pairs; reads Q, K, V (bf16), writes O (bf16) and, for training,
    each row's log-sum-exp (f32)."""
    flops = 2 * 2 * B * H * hd * _pairs(S)
    nbytes = BF16 * (2 * B * S * H * hd + 2 * B * S * KH * hd)
    if lse:
        nbytes += F32 * B * H * S
    return flops, nbytes


def flash_bwd(B: int, S: int, H: int, KH: int, hd: int) -> tuple:
    """(flops, bytes) of its backward: five products over the causal pairs
    (S = Q K^T again, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K);
    reads Q, K, V, O, dO (bf16) and the log-sum-exp (f32), writes dQ, dK,
    dV (bf16)."""
    flops = 5 * 2 * B * H * hd * _pairs(S)
    q_like, kv_like = B * S * H * hd, B * S * KH * hd
    nbytes = BF16 * (3 * q_like + 2 * kv_like) + F32 * B * H * S \
        + BF16 * (q_like + 2 * kv_like)
    return flops, nbytes


def _ssd_products(Bt: int, S: int, H: int, P: int, G: int, N: int,
                  Q: int) -> dict:
    nc = S // Q
    return {
        "CB": 2 * Bt * nc * G * N * _pairs(Q),  # C B^T within a chunk
        "scores_x": 2 * Bt * nc * H * P * _pairs(Q),  # (CB o L) x per head
        "states": 2 * Bt * S * H * P * N,  # each chunk's state from x and B
        "pass": 2 * Bt * nc * H * P * N,  # h = decay h + chunk state
        "carry": 2 * Bt * S * H * P * N,  # C h_in
    }


def ssd_fwd(Bt: int, S: int, H: int, P: int, G: int, N: int,
            Q: int) -> tuple:
    """(flops, bytes) of the chunked SSD's forward at chunk Q: the products
    of its chunked form once each; reads x, B, C (bf16), dt (f32), A and D
    (f32), writes y (bf16) and the final state (f32)."""
    flops = sum(_ssd_products(Bt, S, H, P, G, N, Q).values())
    nbytes = (BF16 * (Bt * S * H * P + 2 * Bt * S * G * N) + F32 * Bt * S * H
              + 2 * F32 * H + BF16 * Bt * S * H * P + F32 * Bt * H * P * N)
    return flops, nbytes


def ssd_bwd(Bt: int, S: int, H: int, P: int, G: int, N: int,
            Q: int) -> tuple:
    """(flops, bytes) of its backward: the two products of each forward
    product's gradient and C B^T once more; reads x, B, C, dy (bf16), dt,
    A, D (f32), writes dx, dB, dC (bf16), ddt, dA, dD (f32)."""
    prods = _ssd_products(Bt, S, H, P, G, N, Q)
    flops = 2 * sum(prods.values()) + prods["CB"]
    x_like, bc_like = Bt * S * H * P, Bt * S * G * N
    nbytes = (BF16 * (2 * x_like + 2 * bc_like) + F32 * (Bt * S * H + 2 * H)
              + BF16 * (x_like + 2 * bc_like) + F32 * (Bt * S * H + 2 * H))
    return flops, nbytes
