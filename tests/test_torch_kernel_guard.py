"""The kernels' CUDA route differentiates.

Each wrapper (``ops.attend``, ``ops.scan``, ``ops.mix``) calls its
kernel on the CUDA branch inside an ``autograd.Function``
(``FlashAttention``, ``LruScan``, ``Wkv6``) with the reference's
backward. The branch is taken here with the route forced and the ctypes
binding replaced by a stand-in that computes the plain version (no
card); the gradients under ``.backward()``, ``torch.func.grad``,
``vjp``, ``vmap(grad)`` and ``grad(vmap)`` equal those of the plain
version on the CPU route, and a vmapped call folds the vmapped axis into
the kernel's batch axis (one launch). The CPU route still differentiates
through the plain version. On the card, ``chip_smoke.phase_llm_train``
(a) holds the real kernels' backwards against autograd of their plain
versions."""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.lru_scan.ref import lru_scan_ref
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref

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


STANDINS = {
    "flash_attention": lambda q, k, v, causal, window, cap: fa_ops.attend(
        q, k, v, causal=causal, window=window, cap=cap, use_kernel=False),
    "lru_scan": lru_scan_ref,
    "wkv6": wkv6_ref,
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
        plain = STANDINS[fn_name]

        def standin(*a, _plain=plain, _name=fn_name, **kw):
            launched.append(_name)
            return _plain(*a, **kw)
        monkeypatch.setattr(mod.kernel, fn_name, standin)
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
