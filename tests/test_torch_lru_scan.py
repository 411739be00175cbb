"""The port's LRU scan (``repro_torch.kernels.lru_scan``) on the CPU, where
it takes its plain version, against live JAX: the Pallas kernel in
interpret mode (``ops.scan(use_pallas=True)``) on every ``LRU_CASES`` row
of ``tests/test_kernels.py``, with and without ``h0``, and the jnp oracle
``lru_scan_ref`` on shapes the Pallas kernel refuses (S or D not a block
multiple). Inputs are drawn with numpy from a seed and handed to both.

Tolerance: 1e-5 (atol and rtol) in fp32, 5e-2 in bf16, as in
``tests/test_kernels.py``. ``h_last`` is the kernel's ``y[:, -1]`` widened
to fp32; the oracle's is the unrounded state, one bf16 rounding away.

``kernel.use_tma``, the rule that sends a CUDA call to the TMA kernel or
the per-thread one, is held on plain values (dtypes, D, base addresses)
against a table written out here."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.lru_scan.ops import scan as jscan  # noqa: E402
from repro.kernels.lru_scan.ref import lru_scan_ref as jref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels.lru_scan import kernel, ops  # noqa: E402

LRU_CASES = [
    # (B, S, D, chunk, bd, dtype), the reference's cases
    (1, 32, 16, 16, 16, "float32"),
    (2, 64, 32, 16, 32, "float32"),
    (2, 128, 64, 32, 64, "float32"),
    (1, 64, 48, 32, 16, "float32"),
    (2, 64, 32, 16, 32, "bfloat16"),
]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(B, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D))))
    b = rng.standard_normal((B, S, D))
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    ja, jb = (jnp.asarray(x, jnp.float32).astype(dtype) for x in (a, b))
    ta, tb = (bridge.to_torch(np.asarray(x)) for x in (ja, jb))
    return (ja, jb, jnp.asarray(h0)), (ta, tb, torch.from_numpy(h0))


def _check(port, ref, dtype):
    tol = TOL[dtype]
    (ty, th), (jy, jh) = port, ref
    assert str(ty.dtype) == f"torch.{dtype}" and th.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("case", LRU_CASES, ids=str)
def test_scan_matches_pallas_interpret(case, with_h0):
    B, S, D, chunk, bd, dtype = case
    (ja, jb, jh0), (ta, tb, th0) = _inputs(B, S, D, dtype)
    ref = jscan(ja, jb, jh0 if with_h0 else None, use_pallas=True,
                chunk=chunk, bd=bd)
    port = ops.scan(ta, tb, th0 if with_h0 else None)
    _check(port, ref, dtype)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 300, 24), "float32"),     # S % 256 != 0
    ((2, 37, 600), "float32"),     # D % 512 != 0
    ((2, 300, 40), "bfloat16"),
    ((2, 33, 520), "float32"),     # ragged for the TMA kernel's tile
    ((1, 270, 136), "bfloat16"),   # (S % 32 != 0, D % 128 != 0) too
])
def test_scan_matches_oracle_off_block_shapes(shape, dtype):
    (ja, jb, jh0), (ta, tb, th0) = _inputs(*shape, dtype, seed=1)
    with pytest.raises(AssertionError):
        jscan(ja, jb, jh0, use_pallas=True)
    _check(ops.scan(ta, tb, th0), jref(ja, jb, jh0), dtype)


def test_h_last_is_last_output_widened():
    _, (ta, tb, th0) = _inputs(2, 40, 8, "bfloat16", seed=2)
    y, h_last = ops.scan(ta, tb, th0)
    assert torch.equal(h_last, y[:, -1].float())
    y32, h32 = ops.scan(ta.float(), tb.float(), th0)
    assert torch.equal(h32, y32[:, -1])


def test_kernel_takes_cuda_tensors_only():
    _, (ta, tb, th0) = _inputs(1, 4, 8, "float32")
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.lru_scan(ta, tb, th0)
    assert kernel.launches == before


# D -> the dtypes whose rows of D elements are a multiple of 16 bytes
ROWS_OF_16_BYTES = {
    45: set(),
    48: {torch.float32, torch.bfloat16},
    600: {torch.float32, torch.bfloat16},
    4096: {torch.float32, torch.bfloat16},
    4100: {torch.float32},         # 4100 * 2 = 8200 bytes
}
DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("offset", [None, "a", "b"])
@pytest.mark.parametrize("D", sorted(ROWS_OF_16_BYTES))
@pytest.mark.parametrize("dtypes", DTYPE_PAIRS,
                         ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
def test_use_tma_takes_16_byte_rows_and_bases(dtypes, D, offset):
    a_dt, b_dt = dtypes
    base = 1 << 20
    a_ptr = base + (a_dt.itemsize if offset == "a" else 0)
    b_ptr = 2 * base + (b_dt.itemsize if offset == "b" else 0)
    want = (offset is None and a_dt in ROWS_OF_16_BYTES[D]
            and b_dt in ROWS_OF_16_BYTES[D])
    assert kernel.use_tma(a_dt, b_dt, D, a_ptr, b_ptr) is want


def test_use_tma_refuses_other_dtypes():
    assert not kernel.use_tma(torch.float16, torch.float32, 4096, 0, 0)
    assert not kernel.use_tma(torch.float32, torch.float64, 4096, 0, 0)
