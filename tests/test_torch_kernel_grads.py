"""The kernels' backwards (``FlashAttention``, ``LruScan``, ``Wkv6``)
against autograd of their plain versions and against the reference's
``ops`` VJPs.

The CUDA branch is taken with each ctypes binding replaced by a stand-in
that computes its plain version (no card here), so what is tested is
each ``Function``'s backward: flash attention's backward binding (its
plain version ``flash_attention_bwd_ref``, from the forward's lse); the
lru_scan backward binding (``lru_scan_bwd_ref``: the one reverse-time
pass, with ``gh_last`` folded into the last step and the h0 gradient);
wkv6's backward binding (``wkv6_chunked_bwd_ref``). The reference's side: ``jax.grad`` through ``repro.kernels.*.ops`` at the
shapes of ``tests/test_kernels.py``, lru_scan through its Pallas kernel
(``interpret=True``) and analytic backward, flash attention and wkv6
through their oracles (what their ``custom_vjp`` backwards
differentiate). fp32 throughout, at ``tests/test_kernels.py``'s 1e-4.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import attend as jattend  # noqa: E402
from repro.kernels.lru_scan.ops import scan as jscan  # noqa: E402
from repro.kernels.wkv6.ops import mix as jmix  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_fwd_ref)
from repro_torch.kernels.lru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.lru_scan.ref import (lru_scan_bwd_ref,  # noqa: E402
                                              lru_scan_ref)
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import (wkv6_chunked_bwd_ref,  # noqa: E402
                                          wkv6_ref)

TOL = 1e-4


def _flash_fwd(q, k, v, causal, window, cap, lse=False):
    o, lse_ = flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                      cap=cap)
    return (o, lse_) if lse else o


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch with stand-in bindings; returns the launch log."""
    log = []
    for mod, name, plain in (
            (fa_ops, "flash_attention", _flash_fwd),
            (fa_ops, "flash_attention_bwd", flash_attention_bwd_ref),
            (lru_ops, "lru_scan", lru_scan_ref),
            (lru_ops, "lru_scan_bwd", lru_scan_bwd_ref),
            (wkv_ops, "wkv6", wkv6_ref),
            (wkv_ops, "wkv6_bwd", wkv6_chunked_bwd_ref)):
        monkeypatch.setattr(mod, "use_kernel_for", lambda x, uk: uk)

        def standin(*a, _plain=plain, _name=name, **kw):
            log.append(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(mod.kernel, name, standin)
    return log


def _rng_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_grads(fn, args, **kw):
    xs = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in args]
    fn(*xs, **kw).backward()
    return [None if x is None else x.grad.numpy() for x in xs]


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f"{what} arg {i}")


@pytest.mark.parametrize("case", [
    # (B, S, H, KV, Dh, window, cap, bq): tests/test_kernels.py's grad
    # case (48 pads to bq=32, GQA, window 16) and a soft-capped MQA one
    (2, 48, 4, 2, 16, 16, 0.0, 32),
    (1, 40, 4, 1, 8, 0, 20.0, 16),
])
def test_flash_attention_backward(case, launches):
    B, S, H, KV, Dh, window, cap, bq = case
    q, k, v, w = _rng_inputs(5, (B, S, H, Dh), (B, S, KV, Dh),
                             (B, S, KV, Dh), (B, S, H, Dh))
    wt = torch.from_numpy(w)

    def loss(q_, k_, v_, use_kernel=True):
        o = fa_ops.attend(q_, k_, v_, causal=True, window=window, cap=cap,
                          bq=bq, bk=bq, use_kernel=use_kernel)
        return (o * wt).sum()

    got = _torch_grads(loss, (q, k, v))
    assert launches == ["flash_attention", "flash_attention_bwd"]
    _close(got, _torch_grads(loss, (q, k, v), use_kernel=False), "plain")
    ref = jax.grad(lambda q_, k_, v_: jnp.sum(jattend(
        q_, k_, v_, causal=True, window=window, cap=cap, bq=bq, bk=bq,
        use_pallas=False) * w), argnums=(0, 1, 2))(q, k, v)
    _close(got, ref, "reference")


@pytest.mark.parametrize("with_h0", [True, False])
def test_lru_scan_backward_runs_the_backward_kernel(with_h0, launches):
    a, b, h0, gy, ghl = _rng_inputs(6, (2, 32, 8), (2, 32, 8), (2, 8),
                                    (2, 32, 8), (2, 8))
    a = 1 / (1 + np.exp(-a))
    gyt, ghlt = torch.from_numpy(gy), torch.from_numpy(ghl)

    def loss(a_, b_, h_, use_kernel=True):
        y, hl = lru_ops.scan(a_, b_, h_, use_kernel=use_kernel)
        return (y * gyt).sum() + (hl * ghlt).sum()

    args = (a, b, h0 if with_h0 else None)
    got = _torch_grads(loss, args)
    # the forward kernel, then the backward kernel: one launch each
    assert launches == ["lru_scan", "lru_scan_bwd"]
    _close(got, _torch_grads(loss, args, use_kernel=False), "plain")
    jargs = tuple(jnp.asarray(x) for x in args if x is not None)

    def jloss(a_, b_, *h):
        y, hl = jscan(a_, b_, *h, use_pallas=True, interpret=True,
                      chunk=8, bd=8)
        return jnp.sum(y * gy) + jnp.sum(hl * ghl)
    ref = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
    _close(got, ref, "reference (Pallas interpret, analytic backward)")


@pytest.mark.parametrize("a_dt,b_dt", [(torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.float32)])
def test_lru_scan_backward_keeps_each_dtype(a_dt, b_dt, launches):
    """Mixed dtypes: da in a's dtype, db in b's, as the reference's
    backward casts them; held against the plain version at bf16's 3e-2."""
    a, b = _rng_inputs(7, (2, 24, 16), (2, 24, 16))
    a = 1 / (1 + np.exp(-a))

    def grads(use_kernel):
        at = torch.tensor(a).to(a_dt).requires_grad_()
        bt = torch.tensor(b).to(b_dt).requires_grad_()
        y, hl = lru_ops.scan(at, bt, use_kernel=use_kernel)
        (y.float().square().sum() + hl.sum()).backward()
        return at.grad, bt.grad

    ga, gb = grads(True)
    assert (ga.dtype, gb.dtype) == (a_dt, b_dt)
    pa, pb = grads(False)
    for g, p in ((ga, pa), (gb, pb)):
        torch.testing.assert_close(g.float(), p.float(), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.parametrize("T,zero_w", [(16, False), (1, False), (33, True)])
def test_wkv6_backward(T, zero_w, launches):
    B, H, N = 1, 2, 8
    r, k, v, w, u, s0 = _rng_inputs(9, *[(B, T, H, N)] * 4, (H, N),
                                    (B, H, N, N))
    w = 0.5 / (1 + np.exp(-w)) + 0.49
    if zero_w:
        w[:, ::5] = 0.0
    u, s0 = 0.1 * u, 0.1 * s0

    def loss(*a, use_kernel=True):
        o, sT = wkv_ops.mix(*a, use_kernel=use_kernel)
        return o.sum() + (sT * 0.1).sum()

    args = (r, k, v, w, u, s0)
    got = _torch_grads(loss, args)
    assert launches == ["wkv6", "wkv6_bwd"]
    _close(got, _torch_grads(loss, args, use_kernel=False), "plain")
    ref = jax.grad(lambda *a: (lambda o, sT: jnp.sum(o) + jnp.sum(sT * 0.1))(
        *jmix(*a, use_pallas=False)), argnums=tuple(range(6)))(*args)
    _close(got, ref, "reference")


def test_wkv6_chunked_plain_version_is_the_plain_loop():
    """Checkpointed chunks change no value and no gradient."""
    r, k, v, w, u = (torch.tensor(x, requires_grad=True) for x in
                     _rng_inputs(3, *[(2, 12, 2, 4)] * 4, (2, 4)))
    outs = []
    for chunk in (12, 5, 1):
        for x in (r, k, v, w, u):
            x.grad = None
        o, s = wkv6_ref(r, k, v, w.sigmoid(), u, chunk=chunk)
        (o.square().sum() + s.sum()).backward()
        outs.append([o, s] + [x.grad.clone() for x in (r, k, v, w, u)])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
