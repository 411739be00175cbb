"""The lru_scan backward kernel's plain version and the ``Function``s
around both kernels.

``lru_scan_bwd_ref`` (the plain version of ``csrc/lru_scan_bwd.cu``: one
loop over reversed time in the kernel's order) against ``jax.vjp`` of the
reference's ``ops.scan(use_pallas=True, interpret=True)``, whose
``custom_vjp`` is the reference's analytic backward: S in {1, 31, 32, 33,
64}, with and without h0, a cotangent on y only, on h_last only and on
both, and a at 0 and at 1; fp32 at ``tests/test_kernels.py``'s 1e-5. The
same function equal (``torch.equal``) to the older route written out
here: the forward's plain version on reversed time with the flips and
concatenations around it, in fp32, bf16 and both mixed dtypes.
``LruScan`` through its CUDA branch with both bindings stood in by their
plain versions (one launch each; ``vmap`` of ``torch.func.grad`` folds
into one backward launch); the backward binding's fake route and its
refusal of CPU tensors. Inputs from numpy seeds.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.lru_scan.ops import scan as jscan  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.lru_scan import kernel, ops  # noqa: E402
from repro_torch.kernels.lru_scan.ref import (lru_scan_bwd_ref,  # noqa: E402
                                              lru_scan_ref)
from repro_torch.roofline.op_cost import OpCost  # noqa: E402

TOL = 1e-5
B, D = 2, 8


def _inputs(seed, S, a_fill=None):
    """a = sigmoid(N(0, 1)) (or ``a_fill`` everywhere), b, h0 and the two
    cotangents N(0, 1), fp32 numpy."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, D))))
    if a_fill is not None:
        a = np.full((B, S, D), a_fill)
    b, gy = (rng.standard_normal((B, S, D)) for _ in range(2))
    h0, ghl = (rng.standard_normal((B, D)) for _ in range(2))
    return [x.astype(np.float32) for x in (a, b, h0, gy, ghl)]


def _check_against_jax(S, with_h0, on=("y", "h_last"), a_fill=None):
    a, b, h0, gy, ghl = _inputs(S, S, a_fill)
    gy, ghl = (x if name in on else np.zeros_like(x)
               for name, x in (("y", gy), ("h_last", ghl)))
    jargs = (a, b, h0) if with_h0 else (a, b)
    (jy, _), vjp = jax.vjp(lambda *x: jscan(*x, use_pallas=True,
                                            interpret=True),
                           *(jnp.asarray(x) for x in jargs))
    want = vjp((jnp.asarray(gy), jnp.asarray(ghl)))
    ta, th0 = torch.from_numpy(a), torch.from_numpy(h0) if with_h0 else None
    y, _ = lru_scan_ref(ta, torch.from_numpy(b), th0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    got = lru_scan_bwd_ref(ta, th0, y, torch.from_numpy(gy),
                           torch.from_numpy(ghl), torch.float32)
    assert (got[2] is None) is (not with_h0)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"gradient {i}")


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 64])
def test_plain_backward_matches_reference_vjp(S, with_h0):
    _check_against_jax(S, with_h0)


@pytest.mark.parametrize("on", [("y",), ("h_last",)])
@pytest.mark.parametrize("S", [1, 33])
def test_plain_backward_one_cotangent(S, on):
    """A cotangent on y alone and on h_last alone (h_last aliases y's last
    step: its cotangent enters lam there and flows back from it)."""
    _check_against_jax(S, True, on)


@pytest.mark.parametrize("a_fill", [0.0, 1.0])
def test_plain_backward_at_the_edges_of_a(a_fill):
    """a = 0 cuts the recurrence (lam_t = c_t); a = 1 makes lam the
    reversed cumulative sum of the cotangents."""
    _check_against_jax(32, True, a_fill=a_fill)


def _older_route(a, h0, y, gy, gh_last, b_dtype):
    """The backward before the kernel: the forward on reversed time with
    coefficients [0, a_{S-1}, ..., a_1], then elementwise products."""
    af = a.float()
    c = gy.float()
    c = torch.cat([c[:, :-1], c[:, -1:] + gh_last.float()[:, None]], 1)
    a_rev = torch.cat([torch.zeros_like(af[:, :1]), af.flip(1)[:, :-1]], 1)
    mu, _ = lru_scan_ref(a_rev, c.flip(1), None)
    lam = mu.float().flip(1)
    h_init = torch.zeros_like(af[:, 0]) if h0 is None else h0.float()
    prev_h = torch.cat([h_init[:, None], y.float()[:, :-1]], 1)
    dh0 = None if h0 is None else af[:, 0] * lam[:, 0]
    return (lam * prev_h).to(a.dtype), lam.to(b_dtype), dh0


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("a_dt,b_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_plain_backward_equals_the_older_route(a_dt, b_dt, with_h0):
    """Bit for bit: the same multiplies and adds in the same order."""
    a, b, h0, gy, ghl = (torch.from_numpy(x) for x in _inputs(3, 45))
    a, b = a.to(a_dt), b.to(b_dt)
    h0 = h0 if with_h0 else None
    y, _ = lru_scan_ref(a, b, h0)
    gy = gy.to(a_dt)
    got = lru_scan_bwd_ref(a, h0, y, gy, ghl, b_dt)
    want = _older_route(a, h0, y, gy, ghl, b_dt)
    assert (got[0].dtype, got[1].dtype) == (a_dt, b_dt)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.fixture
def standins(monkeypatch):
    """The CUDA branch with both bindings stood in by their plain
    versions; returns the launch log."""
    log = []
    monkeypatch.setattr(ops, "use_kernel_for", lambda x, uk: uk)

    def fwd(*a):
        log.append("lru_scan")
        return lru_scan_ref(*a)

    def bwd(*a):
        log.append("lru_scan_bwd")
        return lru_scan_bwd_ref(*a)
    monkeypatch.setattr(kernel, "lru_scan", fwd)
    monkeypatch.setattr(kernel, "lru_scan_bwd", bwd)
    return log


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("a_dt,b_dt", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32)])
def test_function_runs_both_bindings(a_dt, b_dt, with_h0, standins):
    """``LruScan``'s forward and backward launch one binding each; the
    gradients equal autograd of the plain version (the CPU route): bit for
    bit where a is fp32, at bf16's 3e-2 where it is bf16 (there autograd
    adds h_last's cotangent to y's last step in bf16, y's dtype, and the
    kernel in fp32, as the reference does)."""
    a, b, h0, gy, ghl = (torch.from_numpy(x) for x in _inputs(4, 33))

    def grads(use_kernel):
        xs = [a.to(a_dt).requires_grad_(), b.to(b_dt).requires_grad_(),
              h0.clone().requires_grad_() if with_h0 else None]
        y, hl = ops.scan(*xs, use_kernel=use_kernel)
        ((y.float() * gy).sum() + (hl * ghl).sum()).backward()
        return [x.grad for x in xs if x is not None]

    got = grads(True)
    assert standins == ["lru_scan", "lru_scan_bwd"]
    tol = 0 if a_dt == torch.float32 else 3e-2
    for g, w in zip(got, grads(False)):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_vmap_of_grad_is_one_backward_launch(standins):
    """``torch.func.grad`` under ``vmap`` folds the vmapped axis into the
    batch of both kernels: one forward and one backward launch."""
    a, b, h0, gy, _ = (torch.from_numpy(x) for x in _inputs(5, 20))
    stacked = torch.stack([b, 2 * b, -b])

    def loss(b_, use_kernel=True):
        y, hl = ops.scan(a, b_, h0, use_kernel=use_kernel)
        return (y * gy).sum() + hl.square().sum()

    got = torch.func.vmap(torch.func.grad(loss))(stacked)
    assert standins == ["lru_scan", "lru_scan_bwd"]
    want = torch.stack([torch.func.grad(lambda x: loss(x, False))(x)
                        for x in stacked])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_function_has_no_derivative(standins):
    a, b, h0, gy, ghl = (torch.from_numpy(x) for x in _inputs(6, 8))
    a.requires_grad_()
    y, _ = lru_scan_ref(a, b, h0)
    da, _, _ = ops.LruScanBwd.apply(a, h0, y, gy, ghl, torch.float32)
    with pytest.raises(RuntimeError, match="no double backward"):
        da.sum().backward()


@pytest.mark.parametrize("with_h0", [True, False])
def test_backward_binding_fake_route(with_h0, monkeypatch):
    """On fake tensors the backward binding allocates its outputs (db in
    b's dtype, dh0 only where h0 is given), launches nothing, and reports
    its FLOPs and bytes to ``op_cost``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_library():
        raise AssertionError("the fake route must not build or launch")
    monkeypatch.setattr(kernel, "bwd_library", no_library)
    monkeypatch.setattr(kernel, "bwd_launches", 0)
    heard = []
    monkeypatch.setattr(kernels, "LISTENERS", [
        lambda name, ins, outs, flops, tr: heard.append(
            (name, sum(t.numel() * t.element_size() for t in (*ins, *outs)),
             flops))])
    Bf, S, Df = 4, 512, 4096
    with FakeTensorMode(), OpCost() as cost:
        a = torch.empty(Bf, S, Df, dtype=torch.bfloat16)
        row = torch.empty(Bf, Df)
        h0 = row if with_h0 else None
        da, db, dh0 = kernel.lru_scan_bwd(a, h0, a, a, row, torch.float32)
    assert da.shape == a.shape and da.dtype == torch.bfloat16
    assert db.shape == a.shape and db.dtype == torch.float32
    assert (dh0 is None) is (not with_h0) and kernel.bwd_launches == 0
    if with_h0:
        assert dh0.shape == (Bf, Df) and dh0.dtype == torch.float32
    # a, y, gy read and da written in bf16, db in fp32; gh_last, and h0
    # and dh0 where h0 is given
    n_bytes = (4 * 2 + 4) * Bf * S * Df + (3 if with_h0 else 1) * 4 * Bf * Df
    flops = 3.0 * Bf * S * Df
    assert heard == [("lru_scan_bwd", n_bytes, flops)]
    assert cost.kernel_calls == {"lru_scan_bwd": 1} and cost.flops == flops
    assert cost.bytes >= n_bytes


def test_backward_binding_refuses_cpu_tensors():
    a, _, h0, gy, ghl = (torch.from_numpy(x) for x in _inputs(7, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.lru_scan_bwd(a, h0, a, gy, ghl, torch.float32)
    assert kernel.bwd_launches == 0


@pytest.mark.parametrize("dtypes,D,offset,want", [
    ((torch.float32, torch.float32), 4096, 0, True),
    ((torch.bfloat16, torch.float32), 4104, 0, True),
    ((torch.float32, torch.bfloat16), 4100, 0, False),  # db's rows 8200 B
    ((torch.float32, torch.float32), 45, 0, False),
    ((torch.float32, torch.float32), 4096, 4, False),
])
def test_use_tma_bwd(dtypes, D, offset, want):
    """The backward's TMA kernel takes 16-byte bases and rows for a, y and
    gy, and 16-byte rows for db in b's dtype."""
    assert kernel.use_tma_bwd(*dtypes, D, 0, 256, 512 + offset) is want
