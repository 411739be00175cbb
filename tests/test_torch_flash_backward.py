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
fp32, at ``tests/test_kernels.py``'s 1e-4. The bf16 kernel's order of
adds (``flash_attention_bwd_fused_ref``: dQ's parts in key-tile order in
their slabs, the slabs in order, a key tile's head chunks' dK, dV sums in
chunk order) against ``jax.grad`` at 1e-5, over two and three key tiles;
the binding's dQ slabs and scratch at the training shapes, and one launch
a call through a stand-in library.
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
    NEG_INF, flash_attention_bwd_fused_ref, flash_attention_bwd_ref,
    flash_attention_fwd_ref)

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


# (B, Sq, Sk, H, KV, Dh, causal, window, cap, kv_len, per, slabs): the
# fused order over two or three key tiles and three query tiles, against
# the reference's grad: GQA and MQA with the heads split over more blocks
# in the first key tile than the last (``per``: heads a block, a key tile
# each), a window, soft-cap 50, kv_len, Sq != Sk, a ragged Sq, Dh 120,
# 160 and 256 (64-key tiles at the padded widths 192 and 256), and dQ
# over two and three slabs
FUSED_CASES = [
    (2, 150, 150, 4, 2, 16, True, 0, 0.0, None, (1, 2), 1),      # GQA
    (1, 140, 140, 6, 1, 8, True, 0, 0.0, None, (1, 4), 1),       # MQA
    (1, 200, 200, 2, 2, 16, True, 70, 0.0, None, None, 1),       # window
    (1, 130, 130, 4, 4, 8, True, 0, 50.0, None, None, 1),        # cap 50
    (2, 150, 150, 4, 2, 8, False, 0, 0.0, 97, (1, 2), 2),        # kv_len
    (1, 70, 200, 4, 2, 16, False, 0, 0.0, None, 1, 2),           # Sq != Sk
    (1, 37, 37, 2, 1, 16, True, 5, 0.0, None, 1, 1),             # ragged
    (1, 140, 140, 2, 1, 120, True, 0, 0.0, None, None, 1),       # Dh 120
    (1, 150, 150, 4, 2, 160, True, 0, 0.0, None, (1, 1, 2), 1),  # Dh 160
    (1, 130, 130, 2, 1, 256, True, 32, 0.0, None, (1, 1, 2), 1), # Dh 256
    (1, 100, 330, 2, 1, 160, False, 0, 0.0, None, None, 3),      # 3 slabs
]
FUSED_TOL = 1e-5


def _jax_grads(q, k, v, do, kv_len, **kw):
    """``jax.grad`` of the reference: its oracle with ``kv_len`` in its own
    (B, H, S, Dh) layout, else ``ops.attend`` (its custom_vjp's oracle)."""
    if kv_len is not None:
        def t(x):
            return jnp.transpose(x, (0, 2, 1, 3))
        return jax.grad(lambda *x: jnp.sum(t(jref(
            *(t(y) for y in x), kv_len=kv_len, **kw)) * do),
            argnums=(0, 1, 2))(q, k, v)
    return jax.grad(lambda *x: jnp.sum(jattend(
        *x, bq=64, bk=64, use_pallas=False, **kw) * do),
        argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_order_backward_matches_jax_grad(case):
    B, Sq, Sk, H, KV, Dh, causal, window, cap, kv_len, per, slabs = case
    q, k, v, do = _inputs(9, B, Sq, Sk, H, KV, Dh)
    kw = dict(causal=causal, window=window, cap=cap)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_ref(qt, kt, vt, kv_len=kv_len, **kw)
    got = flash_attention_bwd_fused_ref(qt, kt, vt, o, lse, dot,
                                        kv_len=kv_len, per=per,
                                        slabs=slabs, **kw)
    want = _jax_grads(q, k, v, do, kv_len, **kw)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=FUSED_TOL, atol=FUSED_TOL,
                                   err_msg=f"case {case}: d{name}")


@pytest.mark.parametrize("Dh, tiles", [
    (16, (128, 64, 16)), (32, (128, 64, 32)), (64, (128, 64, 64)),
    (120, (128, 64, 128)), (128, (128, 64, 128)), (160, (64, 64, 192)),
    (256, (64, 64, 256))])
def test_bwd_tiles(Dh, tiles):
    assert kernel.bwd_tiles(Dh) == tiles


# (Sq, Sk, H, KV, Dh, causal, window, slabs): the training shapes of
# chip_smoke.py at B 4 (StarCoder2-3B, RecurrentGemma-9B, Danube3,
# StableLM-2, Gemma-2, Granite, Llama-4, Whisper's encoder, cross and
# self, Qwen2-VL) and their dQ slabs
TRAIN_PLANS = [(512, 512, 24, 2, 128, True, 0, 1),
               (512, 512, 16, 1, 256, True, 2048, 1),
               (512, 512, 32, 8, 120, True, 4096, 1),
               (512, 512, 32, 8, 160, True, 0, 1),
               (512, 512, 32, 16, 128, True, 4096, 1),
               (512, 512, 16, 8, 64, True, 0, 1),
               (512, 512, 40, 8, 128, True, 0, 1),
               (1500, 1500, 16, 16, 64, False, 0, 3),
               (500, 1500, 16, 16, 64, False, 0, 3),
               (512, 512, 16, 16, 64, True, 0, 1),
               (512, 512, 64, 8, 128, True, 0, 1)]


@pytest.mark.parametrize("shape", TRAIN_PLANS)
def test_plan_at_the_training_shapes(shape):
    """Non-causal shapes spread their 12 key tiles over 3 dQ slabs, causal
    ones take one; the scratch holds the head chunks' dK, dV sums wherever
    a group has more than one head (the kernel splits StarCoder2-3B's and
    RecurrentGemma-9B's over blocks by the card's SMs), and sems has one
    int per (slab, b, h, query tile), per (b, kv head, key tile) and the
    fault word."""
    Sq, Sk, H, KV, Dh, causal, window, slabs = shape
    assert kernel.bwd_slabs(Sk, Dh, causal, window) == slabs
    q = torch.empty((4, Sq, H, Dh), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, Sk, KV, Dh), dtype=torch.bfloat16, device="meta")
    got = kernel.bwd_scratch(q, k, slabs)
    kt, qt, width = kernel.bwd_tiles(Dh)
    nq, nkt = -(-Sq // qt), -(-Sk // kt)
    assert got["sems"].shape == (slabs * 4 * H * nq + 4 * KV * nkt + 1,)
    assert got["dq_acc"].shape == (slabs, 4, H, nq, qt * width)
    assert (got["kv_acc"] is None) == (H == KV)


# (dtype, B, Sq, Sk, H, KV, Dh)
SCRATCH_CASES = [(torch.bfloat16, 1, 64, 64, 6, 1, 16),
                 (torch.bfloat16, 2, 100, 130, 4, 2, 160),
                 (torch.bfloat16, 4, 512, 512, 32, 8, 120),
                 (torch.float32, 2, 70, 150, 4, 2, 96)]


@pytest.mark.parametrize("case", SCRATCH_CASES)
def test_bwd_scratch_shapes(case):
    """The wrapper's scratch: each row's (lse, D) over whole query tiles,
    dQ's fp32 workspace a query tile a row in each slab, zeroed int32
    semaphores (one per (slab, b, h, query tile), then per (b, kv head,
    key tile), then the fault word), and the head chunks' dK, dV sums
    wherever a group has more than one head; fp32: D alone."""
    dt, B, Sq, Sk, H, KV, Dh = case
    q = torch.empty((B, Sq, H, Dh), dtype=dt)
    k = torch.empty((B, Sk, KV, Dh), dtype=dt)
    slabs = kernel.bwd_slabs(Sk, Dh, True, 0)
    got = kernel.bwd_scratch(q, k, slabs)
    if dt == torch.float32:
        assert got["rows"].shape == (B, H, Sq)
        assert got["rows"].dtype == torch.float32
        assert got["dq_acc"] is got["sems"] is got["kv_acc"] is None
        return
    kt, qt, width = kernel.bwd_tiles(Dh)
    nq, nkt = -(-Sq // qt), -(-Sk // kt)
    assert got["rows"].shape == (B, H, nq * qt, 2)
    assert got["dq_acc"].shape == (slabs, B, H, nq, qt * width)
    assert got["sems"].shape == (slabs * B * H * nq + B * KV * nkt + 1,)
    assert got["sems"].dtype == torch.int32
    assert not got["sems"].any()
    for name in ("rows", "dq_acc"):
        assert got[name].dtype == torch.float32
    if H > KV:
        assert got["kv_acc"].shape == (B, KV, nkt, 2, kt * width)
        assert got["kv_acc"].dtype == torch.float32
    else:
        assert got["kv_acc"] is None


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_backward_binding_launches_once_a_call(dt, monkeypatch):
    """Through a stand-in library: one launch counted a call, the scratch
    handed over (NULL where the dtype takes none), the dQ slabs, the dtype
    code and the current stream passed on."""
    import contextlib
    import types
    calls = []

    class Lib:
        def repro_flash_attention_bwd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kernel, "bwd_library", Lib)
    monkeypatch.setattr(kernel, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(kernel, "bwd_launches", 0)
    B, S, H, KV, Dh = 1, 64, 6, 1, 16
    q = torch.zeros((B, S, H, Dh), dtype=dt)
    k = torch.zeros((B, S, KV, Dh), dtype=dt)
    lse = torch.zeros((B, H, S))
    for n in (1, 2):
        kernel.flash_attention_bwd(q, k, k, q, lse, q)
        assert kernel.bwd_launches == n and len(calls) == n
    args = calls[0]
    scratch, slabs, dtype, stream = args[9:13], args[-3], args[-2], args[-1]
    assert (slabs, stream) == (1, 7)
    if dt == torch.bfloat16:
        # 6 query heads a kv head: the dK/dV parts' scratch as well
        assert dtype == 1 and all(ptr is not None for ptr in scratch)
    else:
        assert dtype == 0
        assert scratch[0] is not None and scratch[1:] == (None,) * 3
