"""The kernels' CUDA route differentiates.

Each wrapper (``ops.attend``, ``ops.scan``, ``ops.mix``) calls its
kernel on the CUDA branch inside an ``autograd.Function``
(``FlashAttention``, ``LruScan``, ``Wkv6``) whose backward is a kernel
too (each through its own backward binding).
The branch is taken here with the route forced and each ctypes binding
replaced by a stand-in that computes the plain version (no card; a
backward binding by the plain version's VJP); the gradients under
``.backward()``, ``torch.func.grad``, ``vjp``, ``vmap(grad)`` and
``grad(vmap)`` equal those of the plain
version on the CPU route, and a vmapped call folds the vmapped axis into
the kernel's batch axis (one launch). The CPU route still differentiates
through the plain version. On the card, ``chip_smoke.phase_llm_train``
(a) holds the real kernels' backwards against autograd of their plain
versions."""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref, lru_scan_ref
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv6_ref_vjp

TRANSFORMS = ["backward", "grad", "vjp", "vmap(grad)", "grad(vmap)"]


def _inputs(requires_grad=False):
    g = torch.Generator().manual_seed(0)

    def t(*shape, decay=False):
        x = torch.randn(*shape, generator=g, dtype=torch.float64)
        return (x.sigmoid() if decay else x).requires_grad_(requires_grad)
    return {
        "attend": (fa_ops, "flash_attention",
                   (t(1, 12, 2, 8), t(1, 12, 2, 8), t(1, 12, 2, 8)),
                   lambda q, k, v, use_kernel=True: fa_ops.attend(
                       q, k, v, window=5, cap=3.0, use_kernel=use_kernel)),
        "scan": (lru_ops, "lru_scan",
                 (t(1, 6, 8, decay=True), t(1, 6, 8), t(1, 8)),
                 lambda a, b, h0, use_kernel=True: lru_ops.scan(
                     a, b, h0, use_kernel=use_kernel)),
        "mix": (wkv_ops, "wkv6",
                (t(1, 6, 2, 8), t(1, 6, 2, 8), t(1, 6, 2, 8),
                 t(1, 6, 2, 8, decay=True), t(2, 8), t(1, 2, 8, 8)),
                lambda r, k, v, w, u, s0, use_kernel=True: wkv_ops.mix(
                    r, k, v, w, u, s0, use_kernel=use_kernel)),
    }


def _flash_standin(q, k, v, causal, window, cap, lse=False):
    o = fa_ops.attend(q, k, v, causal=causal, window=window, cap=cap,
                      use_kernel=False)
    if not lse:
        return o
    return o, flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                      cap=cap)[1]


def _flash_bwd_standin(q, k, v, o, lse, do, causal, window, cap):
    """The plain version's VJP: the same arithmetic as the CPU route's
    backward, so the transforms are held to it exactly."""
    _, vjp = torch.func.vjp(lambda *x: fa_ops.attend(
        *x, causal=causal, window=window, cap=cap, use_kernel=False), q, k, v)
    return vjp(do)


def _wkv6_bwd_standin(r, k, v, w, u, s0, do, ds_T):
    """The plain version's VJP (``wkv6_ref_vjp``) batch row by batch row,
    laid out as the binding returns it: du by row, ds0 always."""
    rows = []
    for b in range(r.shape[0]):
        one = slice(b, b + 1)
        rows.append(wkv6_ref_vjp(
            (do[one], ds_T[one]), r[one], k[one], v[one], w[one], u,
            None if s0 is None else s0[one]))
    dr, dk, dv, dw = (torch.cat(x) for x in list(zip(*rows))[:4])
    du = torch.stack([row[4] for row in rows])
    ds0 = (torch.zeros_like(ds_T) if s0 is None
           else torch.cat([row[5] for row in rows]))
    return dr, dk, dv, dw, du, ds0


STANDINS = {
    "flash_attention": _flash_standin,
    "flash_attention_bwd": _flash_bwd_standin,
    "lru_scan": lru_scan_ref,
    "lru_scan_bwd": lru_scan_bwd_ref,
    "wkv6": wkv6_ref,
    "wkv6_bwd": _wkv6_bwd_standin,
}


@pytest.fixture
def cuda_branch(monkeypatch):
    """Force each wrapper onto its CUDA branch with a stand-in binding
    that counts its launches."""
    launched = []
    for op in ("attend", "scan", "mix"):
        mod, fn_name, _, _ = _inputs()[op]
        monkeypatch.setattr(mod, "use_kernel_for",
                            lambda x, use_kernel: use_kernel)
        for name in (fn_name, fn_name + "_bwd"):
            if name not in STANDINS:
                continue
            plain = STANDINS[name]

            def standin(*a, _plain=plain, _name=name, **kw):
                launched.append(_name)
                return _plain(*a, **kw)
            monkeypatch.setattr(mod.kernel, name, standin)
    return launched


def _scalar(out):
    outs = out if isinstance(out, tuple) else (out,)
    return sum((o.square() * (i + 1)).sum() for i, o in enumerate(outs))


def _grads(call, args, transform, use_kernel):
    f = torch.func
    n = len(args)

    def loss(*xs):
        return _scalar(call(*xs, use_kernel=use_kernel))

    if transform == "backward":
        xs = [x.detach().clone().requires_grad_() for x in args]
        loss(*xs).backward()
        return [x.grad for x in xs]
    if transform == "grad":
        return list(f.grad(loss, argnums=tuple(range(n)))(*args))
    if transform == "vjp":
        out, vjp = f.vjp(loss, *args)
        return list(vjp(torch.ones_like(out)))
    stacked = torch.stack([args[0], 0.5 * args[0]])
    if transform == "vmap(grad)":
        return [f.vmap(f.grad(lambda x0: loss(x0, *args[1:])))(stacked)]
    return [f.grad(lambda xs: f.vmap(lambda x0: loss(x0, *args[1:]))(xs)
                   .sum())(stacked)]


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("op", ["attend", "scan", "mix"])
def test_cuda_branch_differentiates_as_the_plain_version(op, transform,
                                                         cuda_branch):
    mod, fn_name, args, call = _inputs()[op]
    want = _grads(call, args, transform, use_kernel=False)
    assert not cuda_branch
    got = _grads(call, args, transform, use_kernel=True)
    assert fn_name in cuda_branch
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_gradient_free_vmap_passes(cuda_branch):
    """A vmapped call folds the vmapped axis into the batch: one launch
    per wrapper, the plain version's values."""
    for op in ("attend", "scan", "mix"):
        _, fn_name, args, call = _inputs()[op]
        stacked = torch.stack([args[0], 2 * args[0], -args[0]])
        with torch.no_grad():
            want = torch.func.vmap(
                lambda x0: call(x0, *args[1:], use_kernel=False))(stacked)
            got = torch.func.vmap(lambda x0: call(x0, *args[1:]))(stacked)
        assert cuda_branch.count(fn_name) == 1
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_vmap_over_an_argument_without_the_batch_axis(cuda_branch):
    """wkv6's u has no batch axis to fold into: vmapped over u, the rule
    calls the kernel once per vmapped index and stacks."""
    _, _, (r, k, v, w, u, s0), call = _inputs()["mix"]
    us = torch.stack([u, 2 * u, -u])
    with torch.no_grad():
        got = torch.func.vmap(lambda u_: call(r, k, v, w, u_, s0))(us)
        want = [call(r, k, v, w, u_, s0, use_kernel=False) for u_ in us]
    assert cuda_branch.count("wkv6") == 3
    for g, *ws in zip(got, *want):
        torch.testing.assert_close(g, torch.stack(ws), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("op", ["attend", "scan", "mix"])
def test_cpu_route_still_differentiates(op):
    _, _, args, call = _inputs(True)[op]
    out = call(*args)
    out = out[0] if isinstance(out, tuple) else out
    out.square().sum().backward()
    assert all(a.grad is not None for a in args)


@pytest.mark.parametrize("dh,takes", [(120, True), (160, True), (48, False),
                                      (96, False), (200, False)])
def test_bf16_route_head_dims(dh, takes, monkeypatch):
    """The bf16 route hands Dh 120 and 160 (run at the padded widths 128
    and 192 inside the kernel) to the library as they are, with the scale
    of the true Dh and no padded copy; a Dh it has no form for raises
    before the library is touched, with no fallback. The binding is a
    stand-in that records the call (no card)."""
    import contextlib
    import types

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    calls = []

    class Library:
        def repro_flash_attention_fwd(self, *args):
            calls.append(args)
            return 0

    class FakeDevice:
        type = "cuda"

    q = torch.zeros(2, 70, 4, dh, dtype=torch.bfloat16)
    k = torch.zeros(2, 70, 2, dh, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: FakeDevice))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa_kernel, "library", Library)
    monkeypatch.setattr(fa_kernel, "launches", 0)
    if not takes:
        with pytest.raises(ValueError, match="head dim"):
            fa_kernel.flash_attention(q, k, k)
        assert not calls and fa_kernel.launches == 0
        return
    out = fa_kernel.flash_attention(q, k, k, window=16, cap=30.0)
    (args,) = calls
    assert args[0] == q.data_ptr() and args[1] == args[2] == k.data_ptr()
    # (B, H, KV, Sq, Sk, Dh), the scale and the dtype code (1: bf16)
    assert args[5:11] == (2, 4, 2, 70, 70, dh)
    assert args[14] == pytest.approx(dh ** -0.5) and args[16] == 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert fa_kernel.launches == 1
