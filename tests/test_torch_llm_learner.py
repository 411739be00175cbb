"""The LLM learner (``core/learner.py``) against live JAX.

* ``rl_loss``'s value, its LossStats and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``rl_loss`` at the reduced
  StarCoder2-3B, RecurrentGemma-9B and RWKV-6-7B configs in fp32, for a2c
  and ppo, with S = 12 and ``loss_chunk`` = 5 (S is no multiple of it: the
  chunk is the largest divisor, 4). The weights are the port's
  ``init_params`` from a seed, carried into the reference's tree by
  ``bridge.backbone_params_to_reference``. The reference runs its training default
  (``use_pallas_attention=False``: ``blocked_attention``, the chunked
  associative scan, the checkpointed ``wkv6_ref``); the port's CPU route
  runs the plain versions of its kernels. Loss 1e-5, gradients 1e-4
  relative to each leaf's largest entry.
* ``make_train_step``: two steps of Adam and of RMSProp on one batch
  (both gradients are taken at theta_0, the delayed gradient's behavior
  point) against the reference's ``delayed_grad.update`` with JAX's
  gradients; ``n_microbatches=2`` against the full-batch gradient (equal
  token counts per microbatch make them one function); the in-place
  update (``delayed_grad.update_``) against the functional one,
  ``torch.equal`` on every leaf; the geometry refusals.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import delayed_grad as jdg  # noqa: E402
from repro.core import learner as jlearner  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import delayed_grad, learner  # noqa: E402
from repro_torch.models import backbone  # noqa: E402

ARCHS = ["starcoder2-3b", "recurrentgemma-9b", "rwkv6-7b"]
ALGORITHMS = ("a2c", "ppo")
S, CHUNK = 12, 5
GRAD_TOL, LOSS_TOL = 1e-4, 1e-5


def _configs(arch):
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _batch(vocab):
    b = JTokenStream(vocab, 2, S, 3).next_batch()
    rng = np.random.default_rng(0)
    b["advantages"] = rng.standard_normal((2, S)).astype(np.float32)
    b["returns"] = rng.standard_normal((2, S)).astype(np.float32)
    b["behavior_logprob"] = -6 + rng.standard_normal((2, S)).astype(
        np.float32)
    return {k: np.asarray(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """One jitted JAX call per arch: value and gradients for a2c and
    ppo at the same weights."""
    jcfg, cfg = _configs(arch)
    model = backbone.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    params = jax.tree.map(
        lambda t: t.detach().numpy(), bridge.backbone_params_to_reference(
            dict(model.named_parameters()), cfg))
    batch = _batch(jcfg.vocab_size)

    @jax.jit
    def run(p):
        return {alg: jax.value_and_grad(
            lambda q: jlearner.rl_loss(q, jcfg, batch, alg,
                                       loss_chunk=CHUNK),
            has_aux=True)(p) for alg in ALGORITHMS}

    out = jax.tree.map(np.asarray, run(params))
    return {"cfg": cfg, "params": params, "batch": batch, "out": out}


@pytest.fixture(params=ARCHS)
def reference(request):
    return _reference(request.param)


# the train-step tests at one config: the wiring is the same for all
STEP_ARCH = "rwkv6-7b"


def _flat(tree, cfg):
    return bridge.backbone_params_from_jax(tree, cfg)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads(got: dict, want: dict, what: str):
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        err = float((got[name] - w).abs().max()) / scale
        assert err < GRAD_TOL, f"{what} {name}: {err:.2e}"


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_rl_loss_and_gradients_match_jax(reference, algorithm):
    cfg = reference["cfg"]
    (jloss, jst), jgrads = reference["out"][algorithm]
    leaves = {n: p.requires_grad_()
              for n, p in _flat(reference["params"], cfg).items()}
    loss, st = learner.rl_loss(leaves, cfg, _torch_batch(reference["batch"]),
                               algorithm, loss_chunk=CHUNK)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for got, want in zip((loss, *st), (jloss, *jst)):
        assert abs(float(got) - float(want)) < LOSS_TOL, (float(got),
                                                          float(want))
    _assert_grads(dict(zip(leaves, grads)), _flat(jgrads, cfg), algorithm)


def test_microbatches_equal_the_full_batch():
    """n_microbatches=2 (and batch.grad_accumulation=2) split B=2 into
    two rows of S tokens each: the mean of the two losses' gradients is
    the full batch's, whose JAX gradient holds both."""
    reference = _reference(STEP_ARCH)
    cfg = reference["cfg"]
    (_, jst), jgrads = reference["out"]["a2c"]
    seen = []
    # an optimizer that keeps the gradient it is handed and moves nothing
    keep = optim.Optimizer(
        lambda p: (), lambda g, st, p=None: (
            seen.append(g) or {n: torch.zeros_like(x) for n, x in g.items()},
            st))
    params = _flat(reference["params"], cfg)
    for kw in (dict(n_microbatches=2), dict(batch_geometry={
            "grad_accumulation": 2})):
        step = learner.make_train_step(cfg, keep, "a2c", **kw)
        _, stats = step(delayed_grad.init(params, keep),
                        _torch_batch(reference["batch"]))
        assert abs(float(stats["loss"]) - float(jst.total)) < LOSS_TOL
        assert all(g.dtype == torch.float32 for g in seen[-1].values())
        _assert_grads(seen[-1], _flat(jgrads, cfg), "microbatched")


@pytest.mark.parametrize("opt_name", ["adam", "rmsprop"])
def test_two_train_steps_match_jax(opt_name):
    """Two in-place train steps (the stream runtime's) on one batch: each
    step's gradient is JAX's at theta_0 (the behavior point: params_prev
    at K=1), and the optimizer applied to JAX's gradient gives the
    reference's ``delayed_grad.update`` state, params, params_prev,
    moments and counts. The whole step is not held against the reference
    at params: the first Adam/RMSProp steps divide a gradient entry near
    0 by its own size, so gradients 1e-6 apart there move a param by lr
    in two directions."""
    reference = _reference(STEP_ARCH)
    cfg = reference["cfg"]
    jopt = getattr(joptim, opt_name)(lr=1e-3)
    opt = optim.get_optimizer(opt_name, lr=1e-3)
    (_, _), jgrads = reference["out"]["a2c"]
    jstate = jdg.init(jax.tree.map(jnp.asarray, reference["params"]), jopt)
    jupdate = jax.jit(lambda st, g: jdg.update(st, g, jopt))
    seen = []
    capture = optim.Optimizer(
        opt.init, opt.update,
        lambda g, st, p, out: (seen.append(g), opt.update_(g, st, p, out))[1])
    step = learner.make_train_step(cfg, capture, "a2c")
    batch = _torch_batch(reference["batch"])
    dg = delayed_grad.init(_flat(reference["params"], cfg), opt)
    ref = delayed_grad.init(_flat(reference["params"], cfg), opt)
    for i in range(2):
        jstate = jupdate(jstate, jgrads)
        dg, _ = step(dg, batch)
        _assert_grads(seen[i], _flat(jgrads, cfg), f"step {i} gradient")
        ref = delayed_grad.update_(ref, _flat(jgrads, cfg), opt)
    want = bridge.backbone_state_from_jax(jax.tree.map(np.asarray, jstate),
                                          cfg)
    assert int(dg.step) == int(ref.step) == int(want.step) == 2
    for x, y in zip(bridge.tree_leaves(ref), bridge.tree_leaves(want)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("opt_name,kwargs", [
    ("adam", {"lr": 1e-3}), ("rmsprop", {"lr": 1e-3, "momentum": 0.9}),
    ("sgd", {"lr": 0.1}), ("adam", {"lr": 1e-3, "clip_norm": 0.5})])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_update_gives_the_functional_bits(opt_name, kwargs, dtype):
    opt = optim.get_optimizer(opt_name, **kwargs)
    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    params = {"w": torch.randn(5, 7, generator=gen).to(dt),
              "b": torch.randn(7, generator=gen),
              "e": torch.randn(3, 4, generator=gen).to(dt)}
    a = delayed_grad.init(params, opt)
    b = delayed_grad.init({k: v.clone() for k, v in params.items()}, opt)
    for i in range(3):
        grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype) * (i + 1)
                 for k, v in params.items()}
        a = delayed_grad.update(a, grads, opt)
        b = delayed_grad.update_(b, grads, opt)
    for x, y in zip(bridge.tree_leaves(a), bridge.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_train_step_refusals():
    cfg = _configs("rwkv6-7b")[1]
    opt = optim.get_optimizer("adam", lr=1e-3)
    with pytest.raises(ValueError, match="single-replica"):
        learner.make_train_step(cfg, opt, batch_geometry={"n_replicas": 2})
    with pytest.raises(ValueError, match="conflicts with"):
        learner.make_train_step(cfg, opt, n_microbatches=2,
                                batch_geometry={"grad_accumulation": 4})
    dg = delayed_grad.init({"w": torch.zeros(2)}, opt, staleness=2)
    with pytest.raises(ValueError, match="K=1 update"):
        delayed_grad.update_(dg, {"w": torch.zeros(2)}, opt)


def test_prefill_step_and_policy_outputs_on_flat_params():
    """``make_prefill_step`` and ``policy_outputs`` take the learner's
    flat params: the module's own logits and values."""
    from repro_torch.models import backbone
    cfg = _configs("starcoder2-3b")[1]
    gen = torch.Generator().manual_seed(0)
    model = backbone.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    flat = {n: p.detach() for n, p in model.named_parameters()}
    got = learner.make_prefill_step(cfg, 16)(flat, {"tokens": tokens})
    want = backbone.prefill(model, cfg, tokens, 16)
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x, y)
    logits, values, aux = learner.policy_outputs(flat, cfg,
                                                 {"tokens": tokens})
    hidden, _ = backbone.forward(model, cfg, tokens)
    for x, y in zip((logits, values),
                    backbone.logits_and_value(model, cfg, hidden)):
        assert torch.equal(x, y)
    assert logits.shape == (2, 9, cfg.vocab_size) and float(aux) == 0


@pytest.mark.parametrize("vocab,shape", [(5, (2, 300)), (50, (4, 33)),
                                         (1000, (2, 9)), (3, (1, 1))])
def test_embedding_backward_sums_repeated_tokens(vocab, shape):
    """``layers.apply_embed``'s backward (a stable sort by token and a
    pairwise sum of each token's rows) against the plain indexing
    backward in fp64, the same bits on a rerun, and under ``vmap``."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(vocab)
    table = torch.randn(vocab, 6, generator=gen, dtype=torch.float64)
    tokens = torch.randint(0, vocab, shape, generator=gen)
    cot = torch.randn(*shape, 6, generator=gen, dtype=torch.float64)

    def grad(f, tok):
        return torch.func.vjp(lambda t: f(t, tok), table)[1](cot)[0]

    got = grad(layers.apply_embed, tokens)
    np.testing.assert_allclose(
        got.numpy(), grad(lambda t, tok: t[tok], tokens).numpy(),
        rtol=0, atol=1e-12)
    assert torch.equal(got, grad(layers.apply_embed, tokens))
    stacked = torch.stack([tokens, tokens.flip(-1)])
    batched = torch.func.vmap(lambda tok: grad(layers.apply_embed, tok))(
        stacked)
    for b in range(2):
        np.testing.assert_allclose(
            batched[b].numpy(), grad(lambda t, tok: t[tok], stacked[b])
            .numpy(), rtol=0, atol=1e-12)
