"""The port's WKV6 (``repro_torch.kernels.wkv6``) on the CPU, where it
takes its plain version, against live JAX: the Pallas kernel in interpret
mode (``ops.mix(use_pallas=True)``) on every ``WKV_CASES`` row of
``tests/test_kernels.py``, with and without ``s0``, and the model's
``repro.models.rwkv6.wkv6_ref`` for T not a multiple of the chunk and for
T = 1 (a decode step). Inputs are drawn with numpy from a seed and handed
to both.

Tolerance: 1e-5 (atol and rtol) in fp32, 5e-2 in bf16, as in
``tests/test_kernels.py``."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv6.ops import mix as jmix  # noqa: E402
from repro.models.rwkv6 import wkv6_ref as jref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels.wkv6 import kernel, ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

WKV_CASES = [
    # (B, T, H, N, chunk, dtype), the reference's cases
    (1, 16, 1, 8, 8, "float32"),
    (2, 32, 2, 8, 16, "float32"),
    (2, 64, 4, 16, 32, "float32"),
    (1, 32, 2, 16, 32, "bfloat16"),
]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(B, T, H, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, T, H, N)))) + 0.49)
    u = 0.1 * rng.standard_normal((H, N))
    s0 = 0.1 * rng.standard_normal((B, H, N, N))
    jx = [jnp.asarray(x, jnp.float32).astype(dtype) for x in (r, k, v)]
    jx += [jnp.asarray(x, jnp.float32) for x in (w, u, s0)]
    return jx, [bridge.to_torch(np.asarray(x)) for x in jx]


def _check(port, ref, dtype):
    tol = TOL[dtype]
    (to, ts), (jo, js) = port, ref
    assert str(to.dtype) == f"torch.{dtype}" and ts.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=tol, rtol=tol)


@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_mix_matches_pallas_interpret(case, with_s0):
    B, T, H, N, chunk, dtype = case
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _inputs(B, T, H, N,
                                                             dtype)
    ref = jmix(jr, jk, jv, jw, ju, js0 if with_s0 else None,
               use_pallas=True, chunk=chunk)
    _check(ops.mix(r, k, v, w, u, s0 if with_s0 else None), ref, dtype)


@pytest.mark.parametrize("B,T,H,N,dtype", [
    (2, 50, 2, 16, "float32"),     # T % 16 != 0: the Pallas chunk refuses
    (1, 130, 1, 8, "bfloat16"),    # T % 128 != 0 at the default chunk
    (2, 1, 4, 64, "float32"),      # one decode step
    (2, 1, 2, 64, "bfloat16"),
])
def test_mix_matches_model_oracle(B, T, H, N, dtype):
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _inputs(B, T, H, N,
                                                             dtype, seed=1)
    if T > 1:
        with pytest.raises(AssertionError):
            jmix(jr, jk, jv, jw, ju, js0, use_pallas=True, chunk=16)
    _check(ops.mix(r, k, v, w, u, s0), jref(jr, jk, jv, jw, ju, js0), dtype)


def test_model_uses_the_kernel_modules_plain_version():
    assert rwkv6.wkv6_ref is ops.wkv6_ref


def test_kernel_takes_cuda_tensors_only():
    _, (r, k, v, w, u, s0) = _inputs(1, 2, 1, 8, "float32")
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.wkv6(r, k, v, w, u, s0)
    assert kernel.launches == before


# ``wkv6_chunked_ref``: the chunked, sub-chunk-factored form the chunked
# kernel computes, in plain PyTorch. T around the sub-chunk (16), the
# port's chunk (32) and 64, and past the Pallas kernel's chunk of 128;
# w uniform in (1e-4, 0.999): fast enough decay that a naive split of
# 2^{P[t] - P[s]} overflows. Against the Pallas kernel in interpret mode
# where it accepts T (its chunk is min(128, T)), else the model's oracle.
# Tolerance: fp32 1e-5 of max|o| (and of max|s_T|): hundreds of steps of
# 64-term sums in another order, as in chip_smoke.py's WKV_REL_TOL; bf16
# 5e-2 as above.
CHUNKED_T = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 130]


def _fast_decay_inputs(B, T, H, N, dtype, seed, zero_frac=0.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = rng.uniform(1e-4, 0.999, (B, T, H, N))
    w[rng.random(w.shape) < zero_frac] = 0.0
    u = 0.1 * rng.standard_normal((H, N))
    s0 = 0.1 * rng.standard_normal((B, H, N, N))
    jx = [jnp.asarray(x, jnp.float32).astype(dtype) for x in (r, k, v)]
    jx += [jnp.asarray(x, jnp.float32) for x in (w, u, s0)]
    return jx, [bridge.to_torch(np.asarray(x)) for x in jx]


def _check_rel(port, ref, dtype):
    (to, ts), (jo, js) = port, ref
    jo, js = np.asarray(jo, np.float32), np.asarray(js)
    assert str(to.dtype) == f"torch.{dtype}" and ts.dtype == torch.float32
    assert np.isfinite(to.float().numpy()).all()
    assert np.isfinite(ts.numpy()).all()
    if dtype == "bfloat16":
        _check(port, ref, dtype)
        return
    for x, y in ((to.float().numpy(), jo), (ts.numpy(), js)):
        assert np.abs(x - y).max() <= 1e-5 * np.abs(y).max()


@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", CHUNKED_T)
def test_chunked_ref_matches_reference(T, dtype, with_s0):
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _fast_decay_inputs(
        1, T, 2, 16, dtype, seed=T)
    js0, s0 = (js0, s0) if with_s0 else (None, None)
    if T <= 128:
        ref = jmix(jr, jk, jv, jw, ju, js0, use_pallas=True)
    else:
        with pytest.raises(AssertionError):
            jmix(jr, jk, jv, jw, ju, js0, use_pallas=True)
        ref = jref(jr, jk, jv, jw, ju, js0)
    _check_rel(wkv6_chunked_ref(r, k, v, w, u, s0), ref, dtype)


def test_naive_factorisation_overflows_where_chunked_ref_does_not():
    """Over a chunk of 128 steps (the TPU kernel's) at this w, -P passes
    128 (w ~ U(1e-4, 0.999) averages -1.44 in log2 a step) and the naive
    split (r_t 2^{P[t]}) (k_s 2^{-P[s+1]}) gives inf/nan; the sub-chunk
    factoring keeps every factor <= 1 and stays finite and right."""
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _fast_decay_inputs(
        1, 128, 2, 16, "float32", seed=7)
    rf, kf = r.transpose(1, 2), k.transpose(1, 2)           # (B, H, T, N)
    P = torch.log2(w.transpose(1, 2)).cumsum(2)
    P = torch.cat([torch.zeros_like(P[:, :, :1]), P], 2)    # P[0] = 0
    assert (-P[:, :, -1]).max() > 128
    naive = (rf * torch.exp2(P[:, :, :-1])) @ (
        kf * torch.exp2(-P[:, :, 1:])).transpose(2, 3)
    assert not torch.isfinite(naive).all()
    _check_rel(wkv6_chunked_ref(r, k, v, w, u, s0),
               jmix(jr, jk, jv, jw, ju, js0, use_pallas=True), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [33, 65, 130])
def test_chunked_ref_with_zero_decay(T, dtype):
    """w = 0 (the model's exp(-exp(d)) rounds to it once d passes ~4.6):
    log2 w = -inf, so a power across such a step must come out 0, not
    nan, and the exponents after it must keep their low bits (held at the
    same 1e-5 of max|o|). A tenth of the w are 0."""
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _fast_decay_inputs(
        1, T, 2, 16, dtype, seed=T, zero_frac=0.1)
    assert (w == 0).any()
    if T <= 128:
        ref = jmix(jr, jk, jv, jw, ju, js0, use_pallas=True)
    else:
        ref = jref(jr, jk, jv, jw, ju, js0)
    _check_rel(wkv6_chunked_ref(r, k, v, w, u, s0), ref, dtype)


def test_chunk_choice_follows_t_and_n():
    assert not kernel.chunked(1, 64) and not kernel.chunked(kernel.CHUNK - 1, 64)
    assert kernel.chunked(kernel.CHUNK, 64) and kernel.chunked(500, 16)
    assert not kernel.chunked(500, 8)
