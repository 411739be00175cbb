"""The port's MoE FFN (``models/moe.py``, ``models/moe_dropless.py``)
against live JAX on the CPU.

At the reduced Granite-3.0-1B-a400m (4 experts, top-2) and Llama-4-Scout
(4 experts, top-1, a shared expert) configs, in fp32 and bf16, with the
reference's ``init_moe`` weights carried across:

* ``apply_moe`` and ``apply_moe_dropless``: the routing (``gate_idx``)
  equal, outputs at 1e-5 (fp32) and 3e-2 (bf16), aux at 1e-6. The random
  inputs' seeds are ones whose router probabilities have no near-tie
  (two top-k candidates within 1e-5): there a rounding may legitimately
  pick another expert. ``_assert_no_near_ties`` checks it; exact ties
  are tested on their own below;
* exact ties: rows of zeros, whose router probabilities are all equal,
  and a token count that is no multiple of the group, so padded rows
  enter the aux loss: the chosen experts are JAX's, 0..K-1;
* ``capacity_factor=0.5``: the same tokens dropped as JAX drops;
* gradients of ``sum(y²) + aux`` against ``jax.grad`` at 1e-4 (fp32);
* the reference's four ``tests/test_moe.py`` properties, restated for the
  port.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.moe_dropless import (  # noqa: E402
    apply_moe_dropless as japply_dropless)
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.moe_dropless import apply_moe_dropless  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e"]
IMPLS = ["capacity", "dropless"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
AUX_TOL, GRAD_TOL, NEAR_TIE = 1e-6, 1e-4, 1e-5
# (B, S): T = 30 tokens, two groups of 16 with two padded rows
SHAPE = (3, 10)
SEED = 4    # checked by _assert_no_near_ties


def _configs(arch, dtype, **kw):
    return (dataclasses.replace(jget(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                                **kw))


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """The reference's ``init_moe`` weights (numpy), one draw per arch in
    fp32 and in bf16."""
    out = {}
    for dtype in TOL:
        jcfg, _ = _configs(request.param, dtype)
        out[dtype] = jax.tree.map(np.asarray,
                                  jmoe.init_moe(jax.random.key(0), jcfg))
    return request.param, out


def _module(tree, cfg):
    ffn = moe.MoE(cfg, device="meta")
    flat = dict(bridge._flatten(tree))
    ffn.load_state_dict({k: bridge.to_torch(v) for k, v in flat.items()},
                        assign=True)
    return ffn


def _x(shape, D, dtype, seed=SEED, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal(
        (*shape, D)).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    return x


def _jax_x(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _groups(xt, cfg):
    """(n, G, D) of the tokens padded with zero rows to whole groups, as
    ``apply_moe`` pads them."""
    T, D = xt.shape
    G = cfg.moe_group_size
    n = -(-T // G)
    return np.concatenate([xt, np.zeros((n * G - T, D), xt.dtype)]
                          ).reshape(n, G, D)


def _jax_routing(tree, x, jcfg, impl):
    """The reference's (probs, gate_idx) on the rows its MoE routes:
    padded groups (capacity) or the tokens as they are (dropless)."""
    xt = np.asarray(jnp.asarray(x).astype(jcfg.dtype).astype(jnp.float32))
    xt = xt.reshape(-1, xt.shape[-1])
    rows = _groups(xt, jcfg) if impl == "capacity" else xt
    probs = jax.nn.softmax(jnp.asarray(rows) @ tree["router"], axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


def _port_routing(ffn, x, cfg, impl):
    xt = x.reshape(-1, x.shape[-1])
    rows = (torch.from_numpy(_groups(xt.float().numpy(), cfg))
            if impl == "capacity" else xt)
    probs, _, idx = moe.route(rows, ffn.router, cfg.top_k)
    return probs.detach().numpy(), idx.numpy()


def _assert_no_near_ties(probs, k):
    """No two of the k + 1 largest router probabilities of a row lie
    within NEAR_TIE of each other, unless exactly equal (a zero row)."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    gaps = np.abs(np.diff(top, axis=-1))
    assert not ((gaps > 0) & (gaps < NEAR_TIE)).any(), gaps.min()


def _run(impl, ffn, x, cfg):
    fn = moe.apply_moe if impl == "capacity" else apply_moe_dropless
    return fn(ffn, x, cfg)


_JFNS = {"capacity": jax.jit(jmoe.apply_moe, static_argnums=2),
         "dropless": jax.jit(japply_dropless, static_argnums=2)}


def _jrun(impl, tree, x, jcfg):
    return _JFNS[impl](jax.tree.map(jnp.asarray, tree), x, jcfg)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_matches_jax(weights, impl, dtype):
    arch, trees = weights
    jcfg, cfg = _configs(arch, dtype)
    tree = trees[dtype]
    x = _x(SHAPE, cfg.d_model, dtype)
    ffn = _module(tree, cfg)
    jprobs, jidx = _jax_routing(tree, x, jcfg, impl)
    _assert_no_near_ties(jprobs, cfg.top_k)
    _, idx = _port_routing(ffn, _torch_x(x, dtype), cfg, impl)
    np.testing.assert_array_equal(idx, jidx)
    jy, jaux = _jrun(impl, tree, _jax_x(x, dtype), jcfg)
    with torch.no_grad():
        y, aux = _run(impl, ffn, _torch_x(x, dtype), cfg)
    assert y.dtype == getattr(torch, dtype) and y.shape == x.shape
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert abs(float(aux) - float(jaux)) < AUX_TOL


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("impl", IMPLS)
def test_exact_ties_pick_the_lowest_experts(weights, impl, dtype):
    """Zero rows (every router probability equal) choose experts
    0..K-1, as ``jax.lax.top_k`` does; T = 30 pads two more such rows
    into the aux loss of the capacity dispatch."""
    arch, trees = weights
    jcfg, cfg = _configs(arch, dtype)
    tree = trees[dtype]
    zero_rows = [(0, 0), (0, 3), (1, 9), (2, 4), (2, 5)]
    x = _x(SHAPE, cfg.d_model, dtype, zero_rows=zero_rows)
    ffn = _module(tree, cfg)
    _, jidx = _jax_routing(tree, x, jcfg, impl)
    probs, idx = _port_routing(ffn, _torch_x(x, dtype), cfg, impl)
    np.testing.assert_array_equal(idx, jidx)
    flat_idx = idx.reshape(-1, cfg.top_k)
    tied = [b * 10 + s for b, s in zero_rows]
    if impl == "capacity":
        tied += [30, 31]        # the padded rows of the last group
    np.testing.assert_array_equal(
        flat_idx[tied], np.tile(np.arange(cfg.top_k), (len(tied), 1)))
    assert (probs.reshape(-1, cfg.n_experts)[tied]
            == probs.reshape(-1, cfg.n_experts)[tied][:, :1]).all()
    jy, jaux = _jrun(impl, tree, _jax_x(x, dtype), jcfg)
    with torch.no_grad():
        y, aux = _run(impl, ffn, _torch_x(x, dtype), cfg)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert abs(float(aux) - float(jaux)) < AUX_TOL


@pytest.mark.parametrize("dtype", list(TOL))
def test_capacity_drops_the_tokens_jax_drops(weights, dtype):
    """At capacity_factor 0.5 each expert keeps int(16 K 0.5 / 4) slots
    a group: the tokens past them are dropped in JAX's order, so every
    output row is JAX's, the rows with all K choices dropped exactly
    zero on both sides (where no shared expert adds to them)."""
    arch, trees = weights
    jcfg, cfg = _configs(arch, dtype, capacity_factor=0.5)
    tree = trees[dtype]
    x = _x((2, 24), cfg.d_model, dtype)
    jy = np.asarray(_jrun("capacity", tree, _jax_x(x, dtype), jcfg)[0],
                    np.float32)
    with torch.no_grad():
        y = moe.apply_moe(_module(tree, cfg), _torch_x(x, dtype),
                          cfg)[0].float().numpy()
    np.testing.assert_allclose(y, jy, atol=TOL[dtype], rtol=TOL[dtype])
    if not cfg.shared_expert:
        dropped = (jy == 0).all(-1)
        assert dropped.any()
        np.testing.assert_array_equal((y == 0).all(-1), dropped)


@pytest.mark.parametrize("impl", IMPLS)
def test_gradients_match_jax(weights, impl):
    """d(sum(y²) + aux) by every weight and by x, fp32, against
    ``jax.grad``; relative to each leaf's largest entry."""
    arch, trees = weights
    jcfg, cfg = _configs(arch, "float32")
    tree = trees["float32"]
    x = _x(SHAPE, cfg.d_model, "float32")
    fn = jmoe.apply_moe if impl == "capacity" else japply_dropless

    def jloss(p, xx):
        y, aux = fn(p, xx, jcfg)
        return jnp.sum(y.astype(jnp.float32) ** 2) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    ffn = _module(tree, cfg)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = _run(impl, ffn, xt, cfg)
    names = [n for n, _ in ffn.named_parameters()]
    grads = torch.autograd.grad(y.float().square().sum() + aux,
                                [p for _, p in ffn.named_parameters()] + [xt])
    want = dict(bridge._flatten(jax.tree.map(np.asarray, jg)))
    want["x"] = np.asarray(jgx)
    for name, g in zip(names + ["x"], grads):
        w = want[name]
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-6)
        assert err < GRAD_TOL, (name, err)


# the reference's tests/test_moe.py, restated for the port (bf16,
# capacity_factor 4: no drops)
@pytest.mark.parametrize("prop", ["dropless_equals_capacity",
                                  "dropless_handles_drops",
                                  "deterministic", "dropless_grads_finite"])
def test_reference_moe_properties(weights, prop):
    arch, trees = weights
    _, cfg = _configs(arch, "bfloat16")
    ffn = _module(trees["bfloat16"], cfg)
    x = (0.5 * torch.from_numpy(_x((2, 16), cfg.d_model, "bfloat16", seed=1))
         ).to(torch.bfloat16)
    if prop == "dropless_equals_capacity":
        with torch.no_grad():
            y1, a1 = moe.apply_moe(ffn, x, cfg)
            y2, a2 = apply_moe_dropless(ffn, x, cfg)
        assert float((y1.float() - y2.float()).abs().max()) < 2e-2
        assert abs(float(a1 - a2)) < 1e-6
    elif prop == "dropless_handles_drops":
        tight = dataclasses.replace(cfg, capacity_factor=0.5)
        with torch.no_grad():
            y_drp, _ = apply_moe_dropless(ffn, x, tight)
            y_ref, _ = apply_moe_dropless(ffn, x, cfg)
        assert bool(torch.isfinite(y_drp.float()).all())
        torch.testing.assert_close(y_drp.float(), y_ref.float(), atol=1e-3,
                                   rtol=0)
    elif prop == "deterministic":
        with torch.no_grad():
            y1, _ = moe.apply_moe(ffn, x, cfg)
            y2, _ = moe.apply_moe(ffn, x, cfg)
        assert torch.equal(y1, y2)
    else:
        params = dict(ffn.named_parameters())
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        dropless = dataclasses.replace(cfg, moe_impl="dropless")
        y, aux = torch.func.functional_call(ffn, leaves, (x, dropless))
        grads = torch.autograd.grad(y.float().square().sum() + aux,
                                    list(leaves.values()))
        assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
