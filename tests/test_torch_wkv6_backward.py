"""The wkv6 backward kernel's plain version and the ``Function`` around
both kernels.

``wkv6_chunked_bwd_ref`` (the plain version of ``csrc/wkv6_bwd.cu``'s
chunked route, pass for pass: the two state passes, then dr, dk, dv and dw
in the chunk form) against ``jax.grad`` of the reference's
``ops.mix(use_pallas=False)`` (its ``custom_vjp`` differentiates that
oracle) at T in {1, 16, 31, 32, 33, 64}, with and without s0, with a fifth
of the w at 0 and with fast decay down to 1e-4, and the recurrent route's
(``wkv6_recurrent_bwd_ref``, the elementwise step recurrence) on the same
cases; both routes' plain versions at N = 16 and a ragged T of 70 with
w = 0, and the rule that picks one. ``Wkv6`` through its CUDA branch with
both bindings stood in by their plain versions; the backward binding's
fake route. Inputs from numpy seeds, fp32, at ``tests/test_kernels.py``'s
1e-4.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv6.ops import mix as jmix  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.wkv6 import kernel, ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import (  # noqa: E402
    wkv6_bwd_plain, wkv6_chunked_bwd_ref, wkv6_recurrent_bwd_ref, wkv6_ref)

TOL = 1e-4


def _inputs(seed, B, T, H, N, decay):
    rng = np.random.default_rng(seed)
    r, k, v, x = (rng.standard_normal((B, T, H, N)).astype(np.float32)
                  for _ in range(4))
    if decay == "fast":
        # the model's w = exp(-exp(x)), spread down to 1e-4
        w = np.exp(-np.exp(rng.uniform(-3.0, np.log(-np.log(1e-4)),
                                       (B, T, H, N)))).astype(np.float32)
    else:
        w = (0.5 / (1 + np.exp(-x)) + 0.49).astype(np.float32)
        if decay == "zero":
            w[rng.random(w.shape) < 0.2] = 0.0
    u = 0.1 * rng.standard_normal((H, N)).astype(np.float32)
    s0 = 0.1 * rng.standard_normal((B, H, N, N)).astype(np.float32)
    do = rng.standard_normal((B, T, H, N)).astype(np.float32)
    ds_T = 0.1 * rng.standard_normal((B, H, N, N)).astype(np.float32)
    return (r, k, v, w, u, s0), do, ds_T


def _against_jax_grad(plain, args, do, ds_T, with_s0):
    """``plain``'s gradients against ``jax.grad`` of the reference's
    oracle, at TOL."""
    if not with_s0:
        args = args[:5] + (None,)
    dr, dk, dv, dw, du_rows, ds0 = plain(
        *(None if x is None else torch.from_numpy(x) for x in args),
        torch.from_numpy(do), torch.from_numpy(ds_T))
    got = [dr, dk, dv, dw, du_rows.sum(0)] + ([ds0] if with_s0 else [])
    n = len(got)
    want = jax.grad(lambda *a: (lambda o, s: jnp.sum(o * do) + jnp.sum(
        s * ds_T))(*jmix(*a, *([None] * (6 - n)), use_pallas=False)),
        argnums=tuple(range(n)))(*args[:n])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"input {i}")


# each decay with each route's plain version: the chunked route's under the
# decay's own id, the recurrent route's (the one the binding takes at this
# N of 8) under the decay's id and "recurrent"
DECAY_PLAIN = [pytest.param(decay, plain, id=decay + suffix)
               for plain, suffix in ((wkv6_chunked_bwd_ref, ""),
                                     (wkv6_recurrent_bwd_ref, "-recurrent"))
               for decay in ("reference", "zero", "fast")]


@pytest.mark.parametrize("decay,plain", DECAY_PLAIN)
@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("T", [1, 16, 31, 32, 33, 64])
def test_plain_backward_matches_jax_grad(T, with_s0, decay, plain):
    args, do, ds_T = _inputs(T, 2, T, 2, 8, decay)
    _against_jax_grad(plain, args, do, ds_T, with_s0)


@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("plain", [wkv6_chunked_bwd_ref,
                                   wkv6_recurrent_bwd_ref],
                         ids=["chunked", "recurrent"])
def test_each_route_plain_version_at_n16(plain, with_s0):
    """Each route's plain version at N = 16 (the chunked route's smallest
    head), a ragged T of 70 (two whole chunks and 6 steps) and a fifth of
    the w at 0."""
    args, do, ds_T = _inputs(70, 2, 70, 2, 16, "zero")
    _against_jax_grad(plain, args, do, ds_T, with_s0)


@pytest.mark.parametrize("T,N,route", [(70, 16, "chunked"),
                                       (32, 64, "chunked"),
                                       (31, 16, "recurrent"),
                                       (70, 8, "recurrent")])
def test_plain_route_follows_the_binding_rule(T, N, route):
    """``wkv6_bwd_plain`` takes the route ``kernel.chunked`` names, the one
    the binding launches."""
    assert kernel.chunked(T, N) == (route == "chunked")
    args, do, ds_T = _inputs(T, 1, T, 1, N, "zero")
    ts = [torch.from_numpy(x) for x in (*args, do, ds_T)]
    plain = (wkv6_chunked_bwd_ref if route == "chunked"
             else wkv6_recurrent_bwd_ref)
    for a, b in zip(wkv6_bwd_plain(*ts), plain(*ts)):
        assert torch.equal(a, b)


@pytest.fixture
def standins(monkeypatch):
    """The CUDA branch with both bindings stood in by their plain
    versions; returns the launch log."""
    log = []
    monkeypatch.setattr(ops, "use_kernel_for", lambda x, uk: uk)

    def fwd(*a):
        log.append("wkv6")
        return wkv6_ref(*a)

    def bwd(*a):
        log.append("wkv6_bwd")
        return wkv6_chunked_bwd_ref(*a)
    monkeypatch.setattr(kernel, "wkv6", fwd)
    monkeypatch.setattr(kernel, "wkv6_bwd", bwd)
    return log


@pytest.mark.parametrize("T,with_s0", [(1, True), (33, False), (64, True)])
def test_function_runs_both_bindings(T, with_s0, standins):
    """``Wkv6``'s backward launches the backward binding once; the
    gradients equal autograd of the plain version (the CPU route)."""
    args, do, ds_T = _inputs(9, 2, T, 2, 8, "zero")
    if not with_s0:
        args = args[:5] + (None,)
    dot, dst = torch.from_numpy(do), torch.from_numpy(ds_T)

    def grads(use_kernel):
        xs = [None if x is None else torch.tensor(x, requires_grad=True)
              for x in args]
        o, s = ops.mix(*xs, use_kernel=use_kernel)
        ((o * dot).sum() + (s * dst).sum()).backward()
        return [x.grad for x in xs if x is not None]

    got = grads(True)
    assert standins == ["wkv6", "wkv6_bwd"]
    for g, w in zip(got, grads(False)):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_backward_binding_fake_route(monkeypatch):
    """On fake tensors the backward binding allocates its outputs and its
    scratch (the chunk states), launches nothing, and reports its
    FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_library():
        raise AssertionError("the fake route must not build or launch")
    monkeypatch.setattr(kernel, "bwd_library", no_library)
    monkeypatch.setattr(kernel, "bwd_launches", 0)
    heard = []
    monkeypatch.setattr(kernels, "LISTENERS", [
        lambda name, ins, outs, flops, tr: heard.append((name, flops))])
    B, T, H, N = 2, 70, 4, 64
    with FakeTensorMode():
        r = torch.empty(B, T, H, N, dtype=torch.bfloat16)
        w = torch.empty(B, T, H, N)
        u = torch.empty(H, N)
        s = torch.empty(B, H, N, N)
        dr, dk, dv, dw, du_rows, ds0 = kernel.wkv6_bwd(r, r, r, w, u, None,
                                                       r, s)
    assert dr.shape == r.shape and dr.dtype == torch.bfloat16
    assert dw.dtype == torch.float32 and du_rows.shape == (B, H, N)
    assert ds0.shape == (B, H, N, N) and kernel.bwd_launches == 0
    assert heard == [("wkv6_bwd", 17.0 * B * T * H * N * N)]


def test_backward_binding_refuses_cpu_tensors():
    args, do, ds_T = _inputs(10, 1, 4, 2, 8, "reference")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv6_bwd(*(torch.from_numpy(x) for x in args),
                        torch.from_numpy(do), torch.from_numpy(ds_T))
