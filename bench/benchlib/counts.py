"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
training step, and each hand-written kernel's least time (its roofline
bound), all from shapes.

Peaks are NVIDIA's data-sheet figures for the H100 SXM (dense, no
sparsity), at the full 700 W power limit. The bound of a kernel call is
the larger of two times: every input read once and every output written
once at the HBM rate, and the call's least operations at the dense bf16
rate (the operands here are bf16, and no implementation of the same work
beats the tensor cores' bf16 peak). So no implementation of the same work
can read above 100 % of it.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989.4e12

BF16, F32 = 2, 4


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds a call moving ``n_bytes`` and doing ``n_ops``
    FLOP can take on the card."""
    return max(n_bytes / HBM_BYTES_S, n_ops / PEAK_BF16_FLOPS)


def causal_pairs(s: int) -> int:
    """The (query, key) pairs a causal mask keeps over ``s`` positions."""
    return s * (s + 1) // 2


# ------------------------------------------------------------ the model
def matmul_params(cfg: dict) -> int:
    """Parameters of every weight matrix a training step multiplies by:
    the layers' projections and FFN, the LM head and the value head; not
    the embedding table (a lookup), norms, biases or per-channel
    vectors."""
    d, n_layers, vocab = (cfg["hidden_size"], cfg["num_hidden_layers"],
                          cfg["vocab_size"])
    ff = cfg["intermediate_size"]
    if cfg["architecture"] == "starcoder2":
        h, kv, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"])
        layer = d * h * dh * 2 + d * kv * dh * 2 + 2 * d * ff
    elif cfg["architecture"] == "rwkv6":
        rank = cfg["decay_lora_rank"]
        layer = 5 * d * d + 2 * d * rank + 2 * d * ff
    else:
        raise ValueError(f"unknown architecture {cfg['architecture']!r}")
    return n_layers * layer + d * vocab + d


def step_model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over a (batch, seq) token batch:
    2 per multiply-add, times 3 for the forward and the backward, over
    every weight matrix, attention's QK^T and PV over the pairs the causal
    mask keeps, and the WKV recurrence's 5 N^2 + 5 N per (b, h, t). The
    per-layer recompute is not counted."""
    tokens = batch * seq
    flops = 6.0 * matmul_params(cfg) * tokens
    n_layers = cfg["num_hidden_layers"]
    if cfg["architecture"] == "starcoder2":
        h, dh = cfg["num_attention_heads"], cfg["head_dim"]
        flops += 3 * n_layers * 4.0 * batch * h * causal_pairs(seq) * dh
    elif cfg["architecture"] == "rwkv6":
        n = cfg["head_size"]
        h = cfg["hidden_size"] // n
        flops += 3 * n_layers * float(batch * h * seq) * (5 * n * n + 5 * n)
    return flops


# ------------------------------------------------------------ the kernels
def flash_fwd(batch: int, seq: int, heads: int, kv_heads: int,
              head_dim: int) -> tuple:
    """(bytes, FLOP) of one causal self-attention forward in training: q,
    k, v read, o and the rows' fp32 log-sum-exp written; QK^T and PV."""
    q = batch * seq * heads * head_dim * BF16
    kv = 2 * batch * seq * kv_heads * head_dim * BF16
    lse = batch * heads * seq * F32
    ops = 4.0 * batch * heads * causal_pairs(seq) * head_dim
    return q + kv + q + lse, ops


def flash_bwd(batch: int, seq: int, heads: int, kv_heads: int,
              head_dim: int) -> tuple:
    """(bytes, FLOP) of one causal attention backward: q, k, v, o, dO and
    the log-sum-exp read, dq, dk, dv written; five products over the kept
    pairs (S = QK^T again, dV, dP, dQ, dK)."""
    q = batch * seq * heads * head_dim * BF16
    kv = 2 * batch * seq * kv_heads * head_dim * BF16
    lse = batch * heads * seq * F32
    ops = 10.0 * batch * heads * causal_pairs(seq) * head_dim
    return (q + kv + 2 * q + lse) + (q + kv), ops


def wkv6_fwd(batch: int, seq: int, heads: int, n: int) -> tuple:
    """(bytes, FLOP) of one WKV6 forward from a zero state: r, k, v (bf16)
    and w (fp32) read, u read; o (bf16) and the last state (fp32)
    written. 5 N^2 + 5 N FLOP per (b, h, t)."""
    x = batch * seq * heads * n
    state = batch * heads * n * n * F32
    reads = 3 * x * BF16 + x * F32 + heads * n * F32
    ops = float(batch * heads * seq) * (5 * n * n + 5 * n)
    return reads + x * BF16 + state, ops


def wkv6_bwd(batch: int, seq: int, heads: int, n: int) -> tuple:
    """(bytes, FLOP) of one WKV6 backward: r, k, v, w, u, dO and the last
    state's cotangent read; dr, dk, dv, dw, du and the first state's
    gradient written; twice the forward's least FLOP (each forward
    product has two gradient products)."""
    x = batch * seq * heads * n
    state = batch * heads * n * n * F32
    u = heads * n * F32
    inputs = 3 * x * BF16 + x * F32 + u
    return 2 * inputs + x * BF16 + 2 * state, 2.0 * float(
        batch * heads * seq) * (5 * n * n + 5 * n)
