"""Port flash attention (plain version and ``ops.attend`` on CPU tensors)
vs the reference's ``ops.attend(use_pallas=True)``, which runs the Pallas
kernel in interpret mode, on every ``FLASH_CASES`` row. The hand-written
CUDA kernel itself runs only on the card (``chip_smoke.py``); here the
tests pin that a CPU tensor never reaches it."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jref)
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as tref)

# (B, S, H, KV, Dh, causal, window, cap, bq, bk, dtype), as in
# tests/test_kernels.py::FLASH_CASES
FLASH_CASES = [
    (1, 64, 2, 2, 32, True, 0, 0.0, 32, 32, "float32"),
    (2, 128, 4, 2, 64, True, 0, 0.0, 64, 64, "float32"),
    (1, 128, 4, 1, 32, True, 64, 0.0, 32, 64, "float32"),
    (2, 64, 2, 2, 16, False, 0, 0.0, 32, 32, "float32"),
    (1, 96, 4, 4, 32, True, 0, 50.0, 32, 32, "float32"),
    (2, 128, 4, 2, 64, True, 0, 0.0, 64, 64, "bfloat16"),
    (1, 80, 2, 1, 16, True, 32, 0.0, 16, 16, "bfloat16"),
]
# the wrapper pads: S=80 against bq=bk=32, and S=100 at the default 128
PADDED_CASES = [
    (1, 80, 2, 1, 16, True, 32, 0.0, 32, 32, "float32"),
    (2, 100, 4, 2, 32, True, 0, 0.0, 128, 128, "float32"),
    (1, 72, 2, 2, 32, False, 0, 0.0, 32, 32, "float32"),
]


def _inputs(case, seed=0):
    B, S, H, KV, Dh = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh))]


def _tol(dt):
    return 1e-5 if dt == "float32" else 3e-2


@pytest.mark.parametrize("case", FLASH_CASES + PADDED_CASES)
def test_attend_matches_pallas_interpret(case):
    B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case
    q, k, v = _inputs(case)
    jo = jops.attend(*(jnp.asarray(a).astype(dt) for a in (q, k, v)),
                     causal=causal, window=window, cap=cap, bq=bq, bk=bk,
                     use_pallas=True)
    before = kernel.launches
    to = ops.attend(*(torch.from_numpy(a).to(getattr(torch, dt))
                      for a in (q, k, v)),
                    causal=causal, window=window, cap=cap, bq=bq, bk=bk)
    assert kernel.launches == before == 0
    assert to.dtype == getattr(torch, dt) and to.shape == (B, S, H, Dh)
    tol = _tol(dt)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("kv_len", [None, 50])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_ref_matches_jax_ref(case, kv_len):
    B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case
    q, k, v = (np.transpose(a, (0, 2, 1, 3)) for a in _inputs(case, seed=1))
    kw = dict(causal=causal, window=window, cap=cap, kv_len=kv_len)
    jo = jref(*(jnp.asarray(a).astype(dt) for a in (q, k, v)), **kw)
    to = tref(*(torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dt)) for a in (q, k, v)), **kw)
    tol = _tol(dt)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=tol, rtol=tol)


def test_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 64, 32)
    k = torch.zeros(1, 1, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(q, k, k)
    assert kernel.launches == 0


def test_cpu_takes_plain_version_even_when_kernel_asked():
    q, k, v = (torch.from_numpy(a) for a in _inputs(FLASH_CASES[0]))
    a = ops.attend(q, k, v, use_kernel=True)
    b = ops.attend(q, k, v, use_kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kernel.launches == 0


# The CUDA route calls the kernel on the model's layout, unpadded and with
# no kv_len (the kernel masks the ragged tile itself). Ragged S (80, 130,
# 500 against the default 128 blocks) with the window and soft-cap cases of
# FLASH_CASES: (B, S, H, KV, Dh, causal, window, cap, dtype)
UNPADDED_CASES = [
    (1, S, 2, 1, Dh, causal, window, cap, dt)
    for S in (80, 130, 500)
    for (Dh, causal, window, cap) in ((32, True, 64, 0.0), (32, True, 0, 50.0),
                                      (16, False, 0, 0.0))
    for dt in ("float32", "bfloat16")
]


@pytest.mark.parametrize("case", UNPADDED_CASES, ids=str)
def test_unpadded_ref_matches_padded_pallas_interpret(case):
    B, S, H, KV, Dh, causal, window, cap, dt = case
    q, k, v = _inputs(case, seed=2)
    jo = jops.attend(*(jnp.asarray(a).astype(dt) for a in (q, k, v)),
                     causal=causal, window=window, cap=cap, use_pallas=True)
    to = tref(*(torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 2, 1, 3)))).to(getattr(torch, dt))
        for a in (q, k, v)), causal=causal, window=window, cap=cap,
        kv_len=None)
    tol = _tol(dt)
    np.testing.assert_allclose(to.transpose(1, 2).float().numpy(),
                               np.asarray(jo, np.float32), atol=tol, rtol=tol)


def test_kernel_route_passes_model_layout_views_unpadded(monkeypatch):
    """On the kernel route ``ops.attend`` hands the caller's tensors to the
    kernel as they are (no pad, transpose or copy) and returns its output
    as is, so the model's ``out.flatten(-2)`` is a view."""
    seen = {}

    def fake_kernel(q, k, v, *, causal, window, cap):
        seen.update(q=q, k=k, v=v, window=window, cap=cap)
        ot = tref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal, window=window, cap=cap)
        return ot.transpose(1, 2).contiguous()

    monkeypatch.setattr(ops, "use_kernel_for", lambda x, use: use)
    monkeypatch.setattr(kernel, "flash_attention", fake_kernel)
    qkv = torch.randn(2, 130, 4 + 2 * 2, 32, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = ops.attend(q, k, v, causal=True, window=64, cap=30.0)
    assert seen["q"] is q and seen["k"] is k and seen["v"] is v
    assert (seen["window"], seen["cap"]) == (64, 30.0)
    assert out.shape == (2, 130, 4, 32) and out.is_contiguous()
    flat = out.flatten(-2)
    assert flat.data_ptr() == out.data_ptr() and flat._base is out
    ref = ops.attend(q, k, v, causal=True, window=64, cap=30.0,
                     use_kernel=False)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dh", [8, 48, 96])
def test_kernel_refuses_bf16_head_dims_it_has_no_form_for(dh, monkeypatch):
    """The tensor-core kernel takes bf16 Dh in {16, 32, 64, 120, 128, 160,
    256}; any other bf16 Dh raises before the library is touched (the
    device check is stubbed so the test runs on the CPU)."""
    q = torch.zeros(1, 64, 2, dh, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, dh, dtype=torch.bfloat16)

    class FakeDevice:
        type = "cuda"

    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: FakeDevice))
    monkeypatch.setattr(kernel, "library", lambda: pytest.fail("launched"))
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_attention(q, k, k)
    assert kernel.launches == 0
