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
