"""The flash attention backward kernel's plain version, its forward's lse,
and the ``Function`` around both kernels.

``flash_attention_bwd_ref`` (the plain version of
``csrc/flash_attention_bwd.cu``: tiled, in the model's layout, from the
forward's lse) against ``jax.grad`` of the reference's
``ops.attend(use_pallas=False)`` (its ``custom_vjp`` differentiates that
oracle) at ``tests/test_kernels.py``'s grad shape and at Sq != Sk
non-causal, soft-cap, window, MQA and GQA; ``kv_len``, which
``ops.attend`` sets only from its own padding, against ``jax.grad`` of
the reference's ``flash_attention_ref`` with ``kv_len``. The plain
forward's lse against the logsumexp of the reference's masked scores.
``FlashAttention`` through its CUDA branch with both bindings stood in by
their plain versions; the bindings' fake route. Inputs from numpy seeds,
fp32, at ``tests/test_kernels.py``'s 1e-4.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import attend as jattend  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, flash_attention_bwd_ref, flash_attention_fwd_ref)

TOL = 1e-4

# (B, Sq, Sk, H, KV, Dh, causal, window, cap, bq): the reference grad
# test's shape (48 pads to bq=32, GQA, window 16), then the cases the
# kernel covers beside it
CASES = [
    (2, 48, 48, 4, 2, 16, True, 16, 0.0, 32),
    (2, 30, 70, 4, 2, 8, False, 0, 0.0, 16),     # Sq != Sk, non-causal
    (1, 40, 40, 4, 4, 8, True, 0, 20.0, 16),     # soft-cap
    (1, 37, 37, 2, 2, 16, True, 5, 0.0, 16),     # window, ragged tiles
    (2, 33, 33, 6, 1, 8, True, 0, 0.0, 16),      # MQA
    (1, 50, 50, 6, 2, 8, True, 12, 3.0, 32),     # GQA, window and cap
]


def _inputs(seed, B, Sq, Sk, H, KV, Dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh),
             (B, Sq, H, Dh))]


def _plain_grads(q, k, v, do, *, block, **kw):
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_ref(qt, kt, vt, **kw)
    return flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, block=block,
                                   **kw)


def _close(got, want, what):
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"{what}: d{name}")


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case):
    B, Sq, Sk, H, KV, Dh, causal, window, cap, bq = case
    q, k, v, do = _inputs(3, B, Sq, Sk, H, KV, Dh)
    kw = dict(causal=causal, window=window, cap=cap)
    got = _plain_grads(q, k, v, do, block=bq, **kw)
    want = jax.grad(lambda *x: jnp.sum(jattend(
        *x, bq=bq, bk=bq, use_pallas=False, **kw) * do),
        argnums=(0, 1, 2))(q, k, v)
    _close(got, want, f"case {case}")


@pytest.mark.parametrize("kv_len", [1, 19, 40])
def test_plain_backward_with_kv_len(kv_len):
    """A ragged ``kv_len`` (keys past it masked), against the reference's
    oracle in its own (B, H, S, Dh) layout."""
    B, S, H, KV, Dh = 2, 40, 4, 2, 8
    q, k, v, do = _inputs(4, B, S, S, H, KV, Dh)
    kw = dict(causal=False, window=0, cap=0.0, kv_len=kv_len)
    got = _plain_grads(q, k, v, do, block=16, **kw)

    def t(x):
        return jnp.transpose(x, (0, 2, 1, 3))
    want = jax.grad(lambda *x: jnp.sum(t(jref(*(t(y) for y in x), **kw))
                                       * do), argnums=(0, 1, 2))(q, k, v)
    _close(got, want, f"kv_len {kv_len}")


@pytest.mark.parametrize("case", CASES)
def test_forward_lse_is_the_logsumexp_of_the_reference_scores(case):
    """lse = logsumexp of the scaled, capped, masked scores, formed as
    ``repro/kernels/flash_attention/ref.py`` forms them; the output equals
    the reference's."""
    B, Sq, Sk, H, KV, Dh, causal, window, cap, _ = case
    q, k, v, _ = _inputs(5, B, Sq, Sk, H, KV, Dh)
    o, lse = flash_attention_fwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, cap=cap)
    qt, kt, vt = (jnp.transpose(x, (0, 2, 1, 3)) for x in (q, k, v))
    s = jnp.einsum("bhqd,bhkd->bhqk", qt, jnp.repeat(kt, H // KV, 1)
                   ) * Dh ** -0.5
    if cap:
        s = cap * jnp.tanh(s / cap)
    qpos, kpos = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = jnp.where(mask, s, NEG_INF)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.scipy.special.logsumexp(s, -1)), rtol=TOL, atol=TOL)
    want = jnp.transpose(jref(qt, kt, vt, causal=causal, window=window,
                              cap=cap), (0, 2, 1, 3))
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.fixture
def standins(monkeypatch):
    """The CUDA branch with both bindings stood in by their plain
    versions; returns the launch log."""
    log = []
    monkeypatch.setattr(ops, "use_kernel_for", lambda x, uk: uk)

    def fwd(q, k, v, causal=True, window=0, cap=0.0, kv_len=None,
            lse=False):
        log.append("flash_attention")
        o, l_ = flash_attention_fwd_ref(q, k, v, causal=causal,
                                        window=window, cap=cap, kv_len=kv_len)
        return (o, l_) if lse else o

    def bwd(*a, **kw):
        log.append("flash_attention_bwd")
        return flash_attention_bwd_ref(*a, **kw)
    monkeypatch.setattr(kernel, "flash_attention", fwd)
    monkeypatch.setattr(kernel, "flash_attention_bwd", bwd)
    return log


@pytest.mark.parametrize("case", CASES)
def test_function_runs_both_bindings(case, standins):
    """``FlashAttention``'s forward asks for the lse and its backward
    launches the backward binding once; the gradients equal autograd of
    the plain version (the CPU route)."""
    B, Sq, Sk, H, KV, Dh, causal, window, cap, bq = case
    q, k, v, do = _inputs(6, B, Sq, Sk, H, KV, Dh)
    dot = torch.from_numpy(do)

    def grads(use_kernel):
        xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        (ops.attend(*xs, causal=causal, window=window, cap=cap, bq=bq,
                    bk=bq, use_kernel=use_kernel) * dot).sum().backward()
        return [x.grad for x in xs]

    got = grads(True)
    assert standins == ["flash_attention", "flash_attention_bwd"]
    _close(got, grads(False), f"case {case}")


def test_serving_asks_for_no_lse(standins):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(7, 1, 8, 8, 2, 2, 8))
    seen = []
    plain = kernel.flash_attention

    def fwd(*a, **kw):
        seen.append(kw.get("lse", False))
        return plain(*a, **kw)
    kernel.flash_attention = fwd
    with torch.inference_mode():
        ops.attend(q, k, v)
    assert seen == [False]


def test_backward_binding_fake_route(monkeypatch):
    """On fake tensors the backward binding allocates its outputs and its
    D scratch, launches nothing, and reports the five products' FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_library():
        raise AssertionError("the fake route must not build or launch")
    monkeypatch.setattr(kernel, "bwd_library", no_library)
    monkeypatch.setattr(kernel, "bwd_launches", 0)
    heard = []
    monkeypatch.setattr(kernels, "LISTENERS", [
        lambda name, ins, outs, flops, tr: heard.append((name, flops))])
    B, Sq, Sk, H, KV, Dh = 2, 24, 40, 8, 2, 64
    with FakeTensorMode():
        q = torch.empty(B, Sq, H, Dh, dtype=torch.bfloat16)
        k = torch.empty(B, Sk, KV, Dh, dtype=torch.bfloat16)
        lse = torch.empty(B, H, Sq)
        dq, dk, dv = kernel.flash_attention_bwd(q, k, k, q, lse, q,
                                                causal=False)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert dq.dtype == torch.bfloat16 and kernel.bwd_launches == 0
    assert heard == [("flash_attention_bwd", 10.0 * B * H * Sq * Sk * Dh)]


def test_backward_binding_refuses_cpu_tensors():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(8, 1, 8, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 8), q)
