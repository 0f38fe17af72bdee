"""The yardstick's arithmetic, frozen inside the benchmark: the card's
peaks, a decoder's model FLOPs a token, attention's pairs and the
roofline bound of a call.  Everything is computed from shapes, so a
change to the program cannot move it.

The FLOP formula is the program's ``Llama.flops_per_token`` (6 · N_active
+ 12 · L · dim · min(T, W)) without its ``2 · dim · V`` term: that term
counts the fused loss's recompute of the head, which is not model work.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense bf16 and HBM3 (NVIDIA's data sheet, 700 W)
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# FLOP a (query, key) pair costs per head dimension: forward 4 (two
# products), backward 10 (dV, dP, dQ, dK and the recompute of P the
# inputs need once)
ATTN_FWD_FLOP_PER_PAIR_DIM = 4
ATTN_BWD_FLOP_PER_PAIR_DIM = 10


def attention_pairs(T: int, window: int = 0) -> int:
    """(query, key) pairs of one head over a sequence of T: causal,
    T(T+1)/2; with a sliding window W, the sum over t of min(t + 1, W)."""
    if not window or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def active_params(cfg: dict) -> int:
    """Parameters a token's products touch: the attention and FFN
    projections of every layer (the top-k experts and the router of an
    MoE layer), the norms and the head; not the embedding gather."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hd = d // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * hd
    attn = 2 * d * d + 2 * d * kv
    ffn = 3 * d * cfg["intermediate_size"]
    experts = cfg.get("num_local_experts", 0)
    if experts:
        ffn = cfg["num_experts_per_tok"] * ffn + d * experts
    return L * (attn + ffn + 2 * d) + d + d * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, T: int) -> float:
    """6 · N_active + 12 · L · dim · min(T, W): the model's training
    FLOP a token (forward and backward, no recompute)."""
    W = cfg.get("sliding_window") or 0
    span = min(T, W) if W else T
    return (6 * active_params(cfg)
            + 12 * cfg["num_hidden_layers"] * cfg["hidden_size"] * span)


def bound_s(flops: float, nbytes: float) -> tuple:
    """(the least time the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_fwd_bwd(B: int, T: int, H: int, K: int, D: int,
                      window: int = 0, elem: int = 2) -> tuple:
    """(FLOP, bytes) of one attention forward and backward: the pairs'
    14 FLOP a head dimension; q, k, v and dO read once, O, dQ, dK and
    dV written once."""
    pairs = attention_pairs(T, window) * B * H
    flops = (ATTN_FWD_FLOP_PER_PAIR_DIM + ATTN_BWD_FLOP_PER_PAIR_DIM) \
        * pairs * D
    q, kv = B * T * H * D, B * T * K * D
    nbytes = elem * (2 * q + 2 * kv          # q, dO; k, v
                     + 2 * q + 2 * kv)       # O, dQ; dK, dV
    return flops, nbytes


def moe_fwd_bwd(N: int, k: int, E: int, D: int, F: int,
                act_elem: int = 2, weight_elem: int = 4) -> tuple:
    """(FLOP, bytes) of one MoE FFN forward and backward, routed work
    only: N · k rows through three products of 2 · D · F, three times
    (forward, and the two products of the backward); the tokens, the
    router and the expert weights read once, the output, the tokens'
    gradient and the weights' gradients written once."""
    flops = 3 * 3 * 2 * N * k * D * F
    weights = 3 * E * D * F + D * E
    nbytes = (act_elem * 4 * N * D            # x, dY read; Y, dX written
              + weight_elem * 2 * weights)    # W read, dW written
    return flops, nbytes


def pct(x: float) -> float:
    """A share as a percentage; NaN or infinity is a fault, not a value."""
    if not math.isfinite(x):
        raise ValueError(f"share {x!r} is not finite")
    return 100.0 * x
