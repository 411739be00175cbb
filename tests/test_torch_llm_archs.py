"""The five decoders added in the MoE slice against live JAX, on the CPU.

Granite-3.0-1B-a400m and Llama-4-Scout (MoE; Llama-4 with its shared
expert and its NoPE global layer), Gemma-2 (local/global, soft-caps),
H2O-Danube3 and StableLM-2 (layernorm), each at its reduced config in
fp32 with its layer cycle kept (Llama-4 4 layers, Gemma-2 2), the
reference's ``init_params`` weights carried across by
``bridge.backbone_params_from_jax``:

* the full forward's logits, values and aux; prefill's last logits; one
  decode step's logits: 1e-5 (atol and rtol). For the MoE archs the
  routing is checked first: no top-k near-tie within 1e-5 on any real
  token (exact ties, the zero rows that pad a group, pick the same
  experts on both sides);
* ``rl_loss`` (the RL loss plus the load-balance loss) at 1e-5 and every
  gradient leaf at 1e-4 of the leaf's largest entry;
* the bridge's trees (the MoE's ``ffn/{router,w_in,w_gate,w_out,
  shared}`` stacked per cycle position) and an Adam ``DelayedGradState``
  carried both ways, every leaf equal;
* ``launch.serve --arch X --reduced --device cpu`` and ``launch.train
  --arch granite-moe-1b-a400m --reduced --device cpu --steps 2`` run
  (in process), the latter with a nonzero aux printed.
"""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import delayed_grad as jdg  # noqa: E402
from repro.core import learner as jlearner  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import learner  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import backbone, moe  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e", "gemma2-27b",
         "h2o-danube-3-4b", "stablelm-12b"]
B, S, CHUNK = 2, 12, 5
TOL, LOSS_TOL, GRAD_TOL, NEAR_TIE = 1e-5, 1e-5, 1e-4, 1e-5


def _configs(arch):
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _batch(vocab):
    b = JTokenStream(vocab, B, S, 3).next_batch()
    rng = np.random.default_rng(0)
    b["advantages"] = rng.standard_normal((B, S)).astype(np.float32)
    b["returns"] = rng.standard_normal((B, S)).astype(np.float32)
    b["behavior_logprob"] = -6 + rng.standard_normal((B, S)).astype(
        np.float32)
    return {k: np.asarray(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """One jitted JAX call per arch: forward, prefill, one decode step,
    and rl_loss's value and gradients."""
    jcfg, cfg = _configs(arch)
    params = jax.tree.map(np.asarray,
                          jbackbone.init_params(jcfg, jax.random.key(0)))
    batch = _batch(jcfg.vocab_size)
    tokens = jnp.asarray(batch["tokens"])

    @jax.jit
    def run(p):
        hidden, _, aux = jbackbone.forward(p, jcfg, tokens)
        logits, values = jbackbone.logits_and_value(p, jcfg, hidden)
        pre, _, cache = jbackbone.prefill(p, jcfg, tokens[:, :-1], S + 4)
        step, _, _ = jbackbone.decode_step(p, jcfg, tokens[:, -1:], cache,
                                           S - 1)
        grad = jax.value_and_grad(
            lambda q: jlearner.rl_loss(q, jcfg, batch, "a2c",
                                       loss_chunk=CHUNK), has_aux=True)(p)
        return {"logits": logits, "values": values, "aux": aux,
                "prefill": pre, "decode": step, "grad": grad}

    out = jax.tree.map(np.asarray, run(params))
    return {"cfg": cfg, "params": params, "batch": batch, "out": out}


@pytest.fixture(params=ARCHS)
def reference(request):
    return _reference(request.param)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _assert_no_near_ties(probs: list, k: int):
    for p in probs:
        top = -np.sort(-p.detach().numpy().reshape(-1, p.shape[-1]),
                       axis=-1)[:, :k + 1]
        gaps = np.abs(np.diff(top, axis=-1))
        assert not ((gaps > 0) & (gaps < NEAR_TIE)).any(), gaps.min()


def test_forward_prefill_decode_match_jax(reference):
    cfg, out = reference["cfg"], reference["out"]
    model = bridge.params_from_jax(reference["params"], cfg)
    tokens = torch.tensor(reference["batch"]["tokens"])
    probs, route = [], moe.route

    def recording(x, router, k):
        res = route(x, router, k)
        probs.append(res[0])
        return res

    with torch.no_grad(), mock.patch.object(moe, "route", recording):
        hidden, _, aux = backbone.forward(model, cfg, tokens)
    if cfg.family == "moe":
        assert len(probs) == cfg.n_layers
        _assert_no_near_ties(probs, cfg.top_k)
        assert float(aux) > 0
    with torch.no_grad():
        logits, values = backbone.logits_and_value(model, cfg, hidden)
        pre, _, cache = backbone.prefill(model, cfg, tokens[:, :-1], S + 4)
        step, _, _ = backbone.decode_step(model, cfg, tokens[:, -1:], cache,
                                          S - 1)
    _close(logits, out["logits"])
    _close(values, out["values"])
    assert abs(float(aux) - float(out["aux"])) < 1e-6
    _close(pre, out["prefill"])
    _close(step, out["decode"])


def test_rl_loss_and_gradients_match_jax(reference):
    cfg = reference["cfg"]
    (jloss, jst), jgrads = reference["out"]["grad"]
    flat = bridge.backbone_params_from_jax(reference["params"], cfg)
    leaves = {n: p.requires_grad_() for n, p in flat.items()}
    batch = {k: torch.tensor(v) for k, v in reference["batch"].items()}
    loss, st = learner.rl_loss(leaves, cfg, batch, "a2c", loss_chunk=CHUNK)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for got, want in zip((loss, *st), (jloss, *jst)):
        assert abs(got.item() - float(want)) < LOSS_TOL, (got.item(),
                                                          float(want))
    want = bridge.backbone_params_from_jax(jgrads, cfg)
    for name, g in zip(leaves, grads):
        w = want[name]
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        assert err < GRAD_TOL, (name, err)


def test_bridge_round_trips_the_trees(reference):
    """Params and an Adam ``DelayedGradState`` (fp32 moments; the MoE
    router fp32 too) from the reference's tree into the port's flat
    dicts and back: every leaf equal, dtypes kept."""
    cfg, params = reference["cfg"], reference["params"]
    flat = bridge.backbone_params_from_jax(params, cfg)
    if cfg.family == "moe":
        assert flat["layers.0.ffn.router"].dtype == torch.float32
        assert flat["layers.0.ffn.w_in"].shape == (
            cfg.n_experts, cfg.d_model, cfg.d_ff)
    back = bridge.backbone_params_to_reference(flat, cfg)
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, back))
            == jax.tree.structure(jax.tree.map(lambda a: 0, params)))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert x.numpy().dtype == y.dtype and np.array_equal(x.numpy(), y)
    state = jax.tree.map(np.asarray, jdg.init(
        jax.tree.map(jnp.asarray, params), joptim.adam(lr=1e-3)))
    dg = bridge.backbone_state_from_jax(state, cfg)
    assert all(m.dtype == torch.float32 for m in dg.opt_state["m"].values())
    again = bridge.backbone_state_to_reference(dg, cfg)
    for x, y in zip(jax.tree.leaves(again, is_leaf=torch.is_tensor),
                    jax.tree.leaves(state)):
        assert np.array_equal(np.asarray(x), y)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_each_arch(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert "decode 2 steps" in capsys.readouterr().out


def test_serve_launcher_cuts_the_depth():
    res = serve.main(["--arch", "llama4-scout-17b-a16e", "--reduced",
                      "--n-layers", "2", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "2"])
    assert res.cfg.n_layers == 2 and len(res.model.layers) == 2


def test_train_launcher_trains_granite_with_its_aux(capsys):
    train.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device",
                "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                "--log-every", "1"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("step")]
    assert len(lines) == 2
    for line in lines:
        loss = float(line.split("loss=")[1].split()[0])
        aux = float(line.split("aux=")[1].split()[0])
        assert np.isfinite(loss) and aux > 0
