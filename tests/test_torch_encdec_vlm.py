"""Whisper-medium (encoder-decoder) and Qwen2-VL-72B (M-RoPE, vision
prefix) against live JAX, on the CPU.

Each at its reduced config in fp32 (Whisper: 2 encoder layers over 32
frames, 2 decoder layers with cross-attention; Qwen2-VL: 2 layers, Dh
64, an 8-position vision prefix), the reference's ``init_params`` weights
carried across by ``bridge.backbone_params_from_jax``, seeded numpy
inputs (audio frames, patch embeddings, three distinct M-RoPE position
streams):

* the full forward's logits and values, prefill's last logits and one
  decode step's logits (Whisper's decode reads the reference encoder's
  output as ``enc_out``; Qwen2-VL's takes (3, B, 1) positions): 1e-5;
* ``rl_loss`` at 1e-5 and every gradient leaf at 1e-4 of the leaf's
  largest entry (Whisper's encoder leaves through the cross-attention);
* the bridge both ways (``encoder/layers`` stacked, ``xattn`` and
  ``norm_x`` per decoder layer), every leaf equal;
* ``layers.apply_mrope`` alone at Dh 128 (slot bounds 16 and 40) and 64;
* ``n_microbatches=2`` splitting (3, B, S) positions along B: the mean
  of the microbatches' gradients equals JAX's full-batch gradient;
* ``launch.serve --arch X --reduced --device cpu`` (the reference's
  stub inputs) runs.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import learner as jlearner  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import delayed_grad, learner  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import backbone, layers  # noqa: E402

ARCHS = ["whisper-medium", "qwen2-vl-72b"]
B, S, CHUNK = 2, 12, 5
TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


def _configs(arch):
    return (dataclasses.replace(jget(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


def _batch(cfg):
    b = JTokenStream(cfg.vocab_size, B, S, 3).next_batch()
    rng = np.random.default_rng(0)
    b["advantages"] = rng.standard_normal((B, S)).astype(np.float32)
    b["returns"] = rng.standard_normal((B, S)).astype(np.float32)
    b["behavior_logprob"] = -6 + rng.standard_normal((B, S)).astype(
        np.float32)
    if cfg.is_encoder_decoder:
        b["audio_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_prefix:
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        # temporal, height, width: three different streams
        b["mrope_positions"] = np.stack([
            np.broadcast_to(np.arange(S), (B, S)),
            rng.integers(0, 6, (B, S)),
            rng.integers(0, 9, (B, S))]).astype(np.int32)
    return {k: np.array(v) for k, v in b.items()}


_INPUTS = ("mrope_positions", "patch_embeds", "audio_embeds")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """One jitted JAX call per arch: forward, prefill, one decode step,
    and rl_loss's value and gradients."""
    jcfg, cfg = _configs(arch)
    params = jax.tree.map(np.asarray,
                          jbackbone.init_params(jcfg, jax.random.key(0)))
    batch = _batch(jcfg)
    kw = {k: jnp.asarray(batch[k]) for k in _INPUTS if k in batch}
    tokens = jnp.asarray(batch["tokens"])

    @jax.jit
    def run(p):
        hidden, _, _ = jbackbone.forward(p, jcfg, tokens, **kw)
        logits, values = jbackbone.logits_and_value(p, jcfg, hidden)
        pre_kw = dict(kw)
        if "mrope_positions" in kw:
            pre_kw["mrope_positions"] = kw["mrope_positions"][:, :, :-1]
        pre, _, cache = jbackbone.prefill(p, jcfg, tokens[:, :-1], S + 4,
                                          **pre_kw)
        dec_kw = {}
        if jcfg.mrope:
            dec_kw["mrope_positions"] = kw["mrope_positions"][:, :, -1:]
        if jcfg.is_encoder_decoder:
            dec_kw["enc_out"] = jbackbone._run_encoder(p, jcfg,
                                                       kw["audio_embeds"])
        step, _, _ = jbackbone.decode_step(p, jcfg, tokens[:, -1:], cache,
                                           S - 1, **dec_kw)
        grad = jax.value_and_grad(
            lambda q: jlearner.rl_loss(q, jcfg, batch, "a2c",
                                       loss_chunk=CHUNK), has_aux=True)(p)
        return {"logits": logits, "values": values, "prefill": pre,
                "decode": step, "grad": grad}

    out = jax.tree.map(np.asarray, run(params))
    return {"cfg": cfg, "params": params, "batch": batch, "out": out}


@pytest.fixture(params=ARCHS)
def reference(request):
    return _reference(request.param)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads(got: dict, want: dict, what: str):
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        err = float((got[name] - w).abs().max()) / scale
        assert err < GRAD_TOL, f"{what} {name}: {err:.2e}"


def test_forward_prefill_decode_match_jax(reference):
    cfg, out = reference["cfg"], reference["out"]
    model = bridge.params_from_jax(reference["params"], cfg)
    batch = _torch_batch(reference["batch"])
    tokens = batch["tokens"]
    kw = {k: batch[k] for k in _INPUTS if k in batch}
    with torch.no_grad():
        hidden, _, _ = backbone.forward(model, cfg, tokens, **kw)
        logits, values = backbone.logits_and_value(model, cfg, hidden)
        pre_kw = dict(kw)
        dec_kw = {}
        if cfg.mrope:
            pre_kw["mrope_positions"] = kw["mrope_positions"][:, :, :-1]
            dec_kw["mrope_positions"] = kw["mrope_positions"][:, :, -1:]
        if cfg.is_encoder_decoder:
            dec_kw["enc_out"] = backbone.run_encoder(model, cfg,
                                                     kw["audio_embeds"])
        pre, _, cache = backbone.prefill(model, cfg, tokens[:, :-1], S + 4,
                                         **pre_kw)
        step, _, _ = backbone.decode_step(model, cfg, tokens[:, -1:], cache,
                                          S - 1, **dec_kw)
    _close(logits, out["logits"])
    _close(values, out["values"])
    _close(pre, out["prefill"])
    _close(step, out["decode"])


def test_rl_loss_and_gradients_match_jax(reference):
    cfg = reference["cfg"]
    (jloss, jst), jgrads = reference["out"]["grad"]
    flat = bridge.backbone_params_from_jax(reference["params"], cfg)
    leaves = {n: p.requires_grad_() for n, p in flat.items()}
    loss, st = learner.rl_loss(leaves, cfg, _torch_batch(reference["batch"]),
                               "a2c", loss_chunk=CHUNK)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    for got, want in zip((loss, *st), (jloss, *jst)):
        assert abs(got.item() - float(want)) < LOSS_TOL, (got.item(),
                                                          float(want))
    if cfg.is_encoder_decoder:
        assert float(grads["encoder.layers.0.mixer.wq"].abs().max()) > 0
        assert float(grads["layers.0.xattn.wk"].abs().max()) > 0
    _assert_grads(grads, bridge.backbone_params_from_jax(jgrads, cfg), "a2c")


def test_bridge_round_trips_the_trees(reference):
    cfg, params = reference["cfg"], reference["params"]
    flat = bridge.backbone_params_from_jax(params, cfg)
    if cfg.is_encoder_decoder:
        assert len([n for n in flat if n.startswith("encoder.layers.")
                    and n.endswith(".mixer.wq")]) == cfg.n_enc_layers
        assert "layers.1.norm_x.bias" in flat
    else:
        assert not any(n.startswith("encoder.") or ".xattn." in n
                       for n in flat)
    back = bridge.backbone_params_to_reference(flat, cfg)
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, back))
            == jax.tree.structure(jax.tree.map(lambda a: 0, params)))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert x.numpy().dtype == y.dtype and np.array_equal(x.numpy(), y)


@pytest.mark.parametrize("head_dim,bounds", [(128, (16, 40)), (64, (8, 20))])
def test_apply_mrope_matches_jax(head_dim, bounds):
    """The slot bounds of sections (2, 3, 3), and the rotation at three
    different position streams, bit for bit up to fp32 trig."""
    half = head_dim // 2
    slot = layers.mrope_slots(half)
    assert [int((slot < i + 1).sum()) for i in range(2)] == list(bounds)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    want = np.asarray(jax.jit(jlayers.apply_mrope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_microbatches_split_mrope_positions_along_the_batch():
    """n_microbatches=2 splits (3, B, S) positions along B and the
    patch embeddings along B: each microbatch is one row, and the mean of
    the two rows' gradients is JAX's full-batch gradient."""
    reference = _reference("qwen2-vl-72b")
    cfg = reference["cfg"]
    batch = _torch_batch(reference["batch"])
    parts = learner._microbatches(batch, 2)
    for i, mb in enumerate(parts):
        assert torch.equal(mb["mrope_positions"],
                           batch["mrope_positions"][:, i:i + 1])
        assert torch.equal(mb["patch_embeds"], batch["patch_embeds"][i:i + 1])
    (_, jst), jgrads = reference["out"]["grad"]
    seen = []
    keep = optim.Optimizer(
        lambda p: (), lambda g, st, p=None: (
            seen.append(g) or {n: torch.zeros_like(x) for n, x in g.items()},
            st))
    params = bridge.backbone_params_from_jax(reference["params"], cfg)
    step = learner.make_train_step(cfg, keep, "a2c", n_microbatches=2)
    _, stats = step(delayed_grad.init(params, keep), batch)
    assert abs(float(stats["loss"]) - float(jst.total)) < LOSS_TOL
    _assert_grads(seen[-1], bridge.backbone_params_from_jax(jgrads, cfg),
                  "microbatched")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_with_the_stub_inputs(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert "decode 2 steps" in capsys.readouterr().out
