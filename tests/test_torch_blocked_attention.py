"""``models.attention.blocked_attention`` against the reference's, on the
CPU: the forward (the tiled online softmax) and the gradients of q, k, v
through its flash backward (``_BlockedFlash``), at 1e-5 in fp32.

The cases are ``tests/test_attention.py``'s (causal, window, GQA,
non-causal, soft-cap, ragged S), plus the shapes the port adds: a ragged
Sq != Sk (cross-attention, non-causal), ``kv_len`` masking, a causal
Sq < Sk, a window with several blocks skipped, one block (the model's
default q_block 512, k_block 1024), bf16 inputs (3e-2), and the model
route: ``use_pallas_attention=False`` runs it. The backward saves no
(Sq, Sk) tile: every tensor autograd keeps holds O(S) rows.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattention  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from test_attention import CASES  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}

# (B, Sq, Sk, H, KV, D, causal, window, cap, kv_len, q_block, k_block, dtype)
EXTRA = {
    "cross-ragged": (2, 20, 45, 4, 2, 16, False, 0, 0.0, None, 16, 32,
                     "float32"),
    "cross-one-query": (2, 1, 45, 4, 4, 16, False, 0, 0.0, None, 16, 32,
                        "float32"),
    "kv_len": (2, 40, 40, 4, 2, 8, True, 0, 0.0, 29, 16, 16, "float32"),
    "kv_len-noncausal": (1, 24, 50, 2, 1, 16, False, 0, 20.0, 37, 8, 16,
                         "float32"),
    "causal-short-q": (1, 30, 48, 4, 2, 8, True, 0, 0.0, None, 16, 16,
                       "float32"),
    "window-skips": (1, 128, 128, 2, 1, 8, True, 20, 0.0, None, 16, 16,
                     "float32"),
    "default-blocks": (2, 37, 37, 4, 1, 32, True, 0, 0.0, None, 512, 1024,
                       "float32"),
    "bf16": (2, 50, 50, 4, 2, 16, True, 16, 30.0, None, 16, 32, "bfloat16"),
}


def _test_attention_case(case) -> tuple:
    """A ``tests/test_attention.py`` case at its q_block 16, k_block 32."""
    return (2, case["S"], case["S"], case["H"], case["KV"], case["D"],
            case["causal"], case["window"], case["cap"], None, 16, 32,
            "float32")


ALL = {f"test_attention[{i}]": _test_attention_case(c)
       for i, c in enumerate(CASES)}
ALL.update(EXTRA)


def _inputs(case, seed):
    B, Sq, Sk, H, KV, D, *_, dtype = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D),
                      (B, Sq, H, D))]
    return arrs, dtype


@pytest.mark.parametrize("name", sorted(ALL))
def test_forward_and_gradients_match_jax(name):
    case = ALL[name]
    *_, causal, window, cap, kv_len, qb, kb, dtype = case
    (q, k, v, g), dtype = _inputs(case, 3)
    kw = dict(causal=causal, window=window, cap=cap, q_block=qb,
              k_block=kb)
    jdt = getattr(jnp, dtype)

    def jloss(q_, k_, v_):
        o = jattention.blocked_attention(
            q_, k_, v_, kv_len=None if kv_len is None else jnp.int32(kv_len),
            **kw)
        return (o.astype(jnp.float32) * g).sum(), o

    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = attention.blocked_attention(*xs, kv_len=kv_len, **kw)
    (out.float() * torch.from_numpy(g)).sum().backward()
    tol = TOL[dtype]
    assert out.dtype == tdt and out.shape == q.shape

    def close(t, a):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(a, np.float32), atol=tol,
                                   rtol=tol)
    close(out, jo)
    for x, jg in zip(xs, jgrads):
        assert x.grad.dtype == tdt
        close(x.grad, jg)


def test_backward_saves_no_score_tile():
    """Every tensor autograd saves for the backward has at most
    max(Sq, Sk) * H * Dh elements per batch row: no (Sq, Sk) tile is
    kept from the forward."""
    B, Sq, Sk, H, KV, D = 1, 96, 160, 2, 1, 8
    q = torch.randn(B, Sq, H, D, requires_grad=True)
    k = torch.randn(B, Sk, KV, D, requires_grad=True)
    v = torch.randn(B, Sk, KV, D, requires_grad=True)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = attention.blocked_attention(q, k, v, causal=False,
                                          q_block=32, k_block=32)
    assert sizes and max(sizes) <= B * max(Sq, Sk) * H * D
    out.sum().backward()
    assert all(x.grad is not None for x in (q, k, v))


def test_model_route_without_the_kernel_is_blocked(monkeypatch):
    """``use_pallas_attention=False`` runs ``blocked_attention`` for
    full-sequence attention (the reference's routing); True runs
    ``ops.attend`` (whose CPU route is the kernel's plain version)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    calls = []
    real_blocked, real_attend = attention.blocked_attention, fa_ops.attend
    monkeypatch.setattr(attention, "blocked_attention", lambda *a, **k: (
        calls.append("blocked"), real_blocked(*a, **k))[1])
    monkeypatch.setattr(fa_ops, "attend", lambda *a, **k: (
        calls.append("kernel"), real_attend(*a, **k))[1])
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              dtype="float32")
    q = torch.randn(2, 9, cfg.n_heads, cfg.resolved_head_dim)
    k = torch.randn(2, 9, cfg.n_kv_heads, cfg.resolved_head_dim)
    a = attention.full_attention(q, k, k, cfg, causal=True, window=0)
    b = attention.full_attention(
        q, k, k, dataclasses.replace(cfg, use_pallas_attention=True),
        causal=True, window=0)
    assert calls == ["blocked", "kernel"]
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
