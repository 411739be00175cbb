"""The kernels' CUDA route refuses what it cannot differentiate.

``kernels.refuse_grad`` on CPU tensors: it raises under grad mode for an
input that requires grad, and for a ``torch.func`` grad-tracking input
(under ``grad``, ``vjp``, ``jvp`` and at any depth of ``vmap``), and lets
``no_grad``, ``inference_mode``, plain inputs and a gradient-free
``vmap`` through. Each wrapper (``ops.attend``, ``ops.scan``,
``ops.mix``) calls it on its CUDA branch before the kernel: the branch
is taken here with the route and the kernel replaced by stand-ins (no
card). The CPU route still differentiates through the plain version.
On the card, ``chip_smoke.phase_run`` calls the real kernels."""
import pytest
import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops


def _call(t):
    refuse_grad("lru_scan", t, None)
    return t.sum()


def test_refuses_inputs_that_require_grad_under_grad_mode():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="lru_scan CUDA kernel has no "
                                           "backward yet.*queue 1, item 7"):
        _call(x)
    with torch.no_grad():
        _call(x)
    with torch.inference_mode():
        _call(x)
    _call(torch.ones(3))
    with torch.enable_grad():
        _call(x.detach())


@pytest.mark.parametrize("transform", ["grad", "vjp", "jvp", "vmap(grad)",
                                       "grad(vmap)"])
def test_refuses_torch_func_grad_tracking_inputs(transform):
    f = torch.func
    x = torch.ones(2, 3)
    run = {
        "grad": lambda: f.grad(_call)(x[0]),
        "vjp": lambda: f.vjp(_call, x[0]),
        "jvp": lambda: f.jvp(_call, (x[0],), (x[0],)),
        "vmap(grad)": lambda: f.vmap(f.grad(_call))(x),
        "grad(vmap)": lambda: f.grad(lambda y: f.vmap(_call)(y).sum())(x),
    }[transform]
    with pytest.raises(RuntimeError, match="no backward yet"):
        run()


def test_gradient_free_vmap_passes():
    torch.func.vmap(_call)(torch.ones(2, 3))


def _inputs(requires_grad):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(requires_grad)
    return {
        "attend": (fa_ops, "flash_attention", "flash_attention",
                   lambda: fa_ops.attend(t(1, 4, 2, 8), t(1, 4, 2, 8),
                                         t(1, 4, 2, 8))),
        "scan": (lru_ops, "lru_scan", "lru_scan",
                 lambda: lru_ops.scan(t(1, 4, 8).sigmoid(), t(1, 4, 8))),
        "mix": (wkv_ops, "wkv6", "wkv6",
                lambda: wkv_ops.mix(t(1, 4, 2, 8), t(1, 4, 2, 8),
                                    t(1, 4, 2, 8), t(1, 4, 2, 8).sigmoid(),
                                    t(2, 8))),
    }


@pytest.mark.parametrize("op", ["attend", "scan", "mix"])
def test_each_wrapper_guards_its_cuda_branch(op, monkeypatch):
    mod, fn_name, what, _ = _inputs(False)[op]
    launched = []
    monkeypatch.setattr(mod, "use_kernel_for", lambda x, use_kernel: True)
    monkeypatch.setattr(mod.kernel, fn_name,
                        lambda *a, **kw: launched.append(1) or a[0])
    call = _inputs(True)[op][3]
    with pytest.raises(RuntimeError, match=f"the {what} CUDA kernel"):
        call()
    assert not launched
    with torch.inference_mode():
        call()
    with torch.no_grad():
        call()
    assert len(launched) == 2


@pytest.mark.parametrize("op", ["attend", "scan", "mix"])
def test_cpu_route_still_differentiates(op):
    out = _inputs(True)[op][3]()
    out = out[0] if isinstance(out, tuple) else out
    out.square().sum().backward()
