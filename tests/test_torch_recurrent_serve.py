"""Reduced RecurrentGemma-9B and RWKV-6-7B on the CPU, where the port's
recurrences take their plain versions, against live JAX, with the JAX
weights carried across by ``bridge.params_from_jax``.

- ``apply_rglru_block`` and ``apply_rwkv6_block`` alone, with and without
  a cache, S > 1 and S = 1: outputs and new cache leaves within 1e-4
  (atol and rtol, fp32).
- prefill + 4 ``decode_step``s of the whole model (JAX with the Pallas
  flash kernel in interpret mode for the local-attention layers): logits,
  values and every cache leaf. fp32 within 1e-4 with equal greedy tokens;
  bf16 within 5e-2 relative max error (the port is fed the reference's
  tokens there, so a bf16 near-tie cannot fork the two continuations).
  RecurrentGemma's prompts are longer than its reduced window 64, so the
  local layers decode against a ring cache; a 4-layer variant adds a
  left-over (``rem``) layer to the 3-layer cycle.
- the recurrent state written by prefill is what decode reads: prefill
  of all but the last token and one decode step give the full forward's
  last logits (1e-4, fp32)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import learner  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import backbone, rglru, rwkv6  # noqa: E402

B, N_DECODE = 2, 4
ARCHS = ("recurrentgemma-9b", "rwkv6-7b")


def _cfgs(arch, dtype="float32", **kw):
    kw = dict(dtype=dtype, use_pallas_attention=True, **kw)
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9)


def _close(a, ref, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_numbers_match_reference(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jget_config(arch)))


# ------------------------------------------------------------ blocks
MIXERS = {
    "rglru": (jrglru.init_rglru, jrglru.apply_rglru_block, rglru.RGLRU,
              rglru.apply_rglru_block, "recurrentgemma-9b"),
    "rwkv6": (jrwkv6.init_rwkv6, jrwkv6.apply_rwkv6_block, rwkv6.RWKV6,
              rwkv6.apply_rwkv6_block, "rwkv6-7b"),
}


def _random_cache(kind, cfg, rng):
    D, H, N = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    if kind == "rglru":
        shapes = {"h": (B, D), "conv": (B, cfg.conv_width - 1, D)}
    else:
        shapes = {"state": (B, H, N, N), "xprev": (B, 1, D)}
    return {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("S", [9, 1])
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_block_matches_jax(kind, S, with_cache):
    jinit, japply, Module, apply, arch = MIXERS[kind]
    jcfg, cfg = _cfgs(arch)
    jparams = _np(jinit(jax.random.key(0), jcfg))
    module = Module(cfg, device="meta")
    module.load_state_dict({k: bridge.to_torch(v)
                            for k, v in jparams.items()}, assign=True)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cache = _random_cache(kind, cfg, rng) if with_cache else None
    j_out, j_cache = japply(jparams, jnp.asarray(x), jcfg,
                            cache=None if cache is None
                            else jax.tree.map(jnp.asarray, cache))
    with torch.inference_mode():
        t_out, t_cache = apply(
            module, torch.from_numpy(x), cfg,
            None if cache is None
            else {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(t_out.numpy(), j_out)
    assert set(t_cache) == set(j_cache)
    for name, leaf in _np(j_cache).items():
        assert t_cache[name].dtype == bridge.to_torch(leaf).dtype
        _close(t_cache[name].numpy(), leaf)


# ------------------------------------------------------------ the models
VARIANTS = {
    # name: (arch, dtype, prompt_len, config overrides)
    "recurrentgemma_f32": ("recurrentgemma-9b", "float32", 80, {}),
    "recurrentgemma_bf16": ("recurrentgemma-9b", "bfloat16", 70, {}),
    "recurrentgemma_rem_f32": ("recurrentgemma-9b", "float32", 70,
                               {"n_layers": 4}),
    "rwkv6_f32": ("rwkv6-7b", "float32", 40, {}),
    "rwkv6_bf16": ("rwkv6-7b", "bfloat16", 40, {}),
}


def _run_jax(cfg, params, prompts):
    S = prompts.shape[1]
    logits, value, cache = jax.jit(
        lambda p, t: jbackbone.prefill(p, cfg, t, S + N_DECODE))(
            params, jnp.asarray(prompts))
    step = jax.jit(lambda p, t, c, pos: jbackbone.decode_step(
        p, cfg, t, c, pos))
    outs = [(logits, value)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [tok]
    for i in range(N_DECODE):
        logits, value, cache = step(params, tok[:, None], cache,
                                    jnp.int32(S + i))
        outs.append((logits, value))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(tok)
    return _np(outs), np.stack(_np(toks), 1), _np(cache)


def _run_port(cfg, model, prompts, forced_tokens=None):
    S = prompts.shape[1]
    with torch.inference_mode():
        logits, value, cache = backbone.prefill(
            model, cfg, torch.from_numpy(prompts), S + N_DECODE)
        serve_step = learner.make_serve_step(cfg)
        outs = [(logits, value)]
        toks = [torch.argmax(logits, -1)]
        for i in range(N_DECODE):
            tok = (toks[-1] if forced_tokens is None
                   else torch.from_numpy(forced_tokens[:, i]).long())
            logits, value, cache = serve_step(model, tok[:, None], cache,
                                              S + i)
            outs.append((logits, value))
            toks.append(torch.argmax(logits, -1))
    return outs, torch.stack(toks, 1).numpy(), cache


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_decode_match_jax(variant):
    arch, dtype, prompt_len, over = VARIANTS[variant]
    jcfg, cfg = _cfgs(arch, dtype, **over)
    jparams = jbackbone.init_params(jcfg, jax.random.key(0))
    if over.get("n_layers") == 4:
        assert len(jparams["rem"]) == 1
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, prompt_len)).astype(np.int32)
    j_outs, j_toks, j_cache = _run_jax(jcfg, jparams, prompts)

    model = bridge.params_from_jax(_np(jparams), cfg, device="cpu")
    fp32 = dtype == "float32"
    t_outs, t_toks, t_cache = _run_port(cfg, model, prompts,
                                        None if fp32 else j_toks)
    j_layers = bridge.cache_from_jax(j_cache, cfg)
    assert len(t_cache) == len(j_layers) == cfg.n_layers
    if fp32:
        np.testing.assert_array_equal(t_toks, j_toks)
    for (tl, tv), (jl, jv) in zip(t_outs, j_outs):
        if fp32:
            _close(tl.numpy(), jl)
            _close(tv.numpy(), jv)
        else:
            assert _rel(tl.numpy(), jl) < 5e-2
            assert np.abs(tv.numpy() - jv).max() <= 5e-2
    for tc, jc in zip(t_cache, j_layers):
        assert set(tc) == set(jc)
        for name in jc:
            assert tc[name].dtype == jc[name].dtype, name
            if fp32:
                _close(tc[name].numpy(), jc[name].numpy())
            else:
                assert _rel(tc[name].float().numpy(),
                            jc[name].float().numpy()) < 5e-2, name


# ------------------------------------------------------------ cache carry
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reads_the_state_prefill_wrote(arch):
    """Without the backbone keeping each layer's returned cache, decode
    would start the recurrences from zeros and miss the full forward."""
    _, cfg = _cfgs(arch)
    model = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, 24),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        hidden, _, _ = backbone.forward(model, cfg, tokens)
        full, _ = backbone.logits_and_value(model, cfg, hidden[:, -1:])
        _, _, cache = backbone.prefill(model, cfg, tokens[:, :-1], 24)
        state = cache[0]["h" if "h" in cache[0] else "state"]
        assert state.abs().max() > 0
        step, _, _ = backbone.decode_step(model, cfg, tokens[:, -1:], cache,
                                          23)
    _close(step.numpy(), full[:, 0].numpy())


# ------------------------------------------------------------ bridge, launcher
def test_bridge_keeps_recurrent_dtypes():
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch, "bfloat16")
        model = bridge.params_from_jax(
            _np(jbackbone.init_params(jcfg, jax.random.key(3))), cfg,
            device="cpu")
        mixer = model.layers[0].mixer
        fp32 = (("w_a", "w_i", "b_a", "b_i", "lambda_param", "conv_b")
                if arch.startswith("recurrentgemma")
                else ("mu", "w0", "w_lora_a", "w_lora_b", "u", "ln_scale"))
        for name, p in mixer.named_parameters():
            want = torch.float32 if name in fp32 else torch.bfloat16
            assert p.dtype == want, (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_main_in_process(arch):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "70", "--gen", "4"]
    greedy = serve.main(argv)
    assert greedy.tokens.shape == (2, 4)
    assert greedy.cfg.use_pallas_attention
    assert torch.isfinite(greedy.prefill_logits).all()
    s1 = serve.main(argv + ["--temperature", "1.0", "--seed", "3"])
    s2 = serve.main(argv + ["--temperature", "1.0", "--seed", "3"])
    torch.testing.assert_close(s1.tokens, s2.tokens, rtol=0, atol=0)


def test_launcher_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", arch, "--reduced", "--batch", "1",
                        "--prompt-len", "4", "--gen", "2"])
