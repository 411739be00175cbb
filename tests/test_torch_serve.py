"""Reduced StarCoder2 prefill + decode: the port on CPU vs live JAX, with
the JAX weights carried across by ``bridge.params_from_jax``.

JAX runs with ``use_pallas_attention`` True (the Pallas kernel in
interpret mode) and False (its jnp blocked attention); the port's prefill
takes the plain flash version on CPU either way. Logits, values and every
cache leaf are compared: fp32 within 1e-4 with equal greedy tokens, bf16
within 5e-2 relative max error."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import learner  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import backbone  # noqa: E402

B, N_DECODE = 2, 4
# the reduced StarCoder2 as is, and turned into a local/global decoder
# (sliding window with a ring cache, softcaps, swiglu, rmsnorm, a
# two-layer cycle) to drive the dense decoder's other code paths
VARIANTS = {
    "starcoder2": {},
    "local_global": dict(mixer_cycle=("attn_local", "attn_full"), window=16,
                         attn_softcap=50.0, final_softcap=30.0,
                         mlp_kind="swiglu", norm_kind="rmsnorm"),
}


def _cfgs(dtype, pallas, variant="starcoder2"):
    kw = dict(dtype=dtype, use_pallas_attention=pallas, **VARIANTS[variant])
    return (dataclasses.replace(jget_config("starcoder2-3b").reduced(), **kw),
            dataclasses.replace(get_config("starcoder2-3b").reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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
    """Greedy, or fed the reference's tokens (so a bf16 near-tie cannot
    send the two runs down different continuations)."""
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


def _rel(a, ref):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return np.abs(a - ref).max() / (np.abs(ref).max() + 1e-9)


@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("dtype,prompt_len,variant", [
    ("float32", 130, "starcoder2"),
    ("bfloat16", 20, "starcoder2"),
    ("float32", 40, "local_global"),
])
def test_prefill_decode_match_jax(dtype, prompt_len, variant, pallas):
    jcfg, cfg = _cfgs(dtype, pallas, variant)
    jparams = jbackbone.init_params(jcfg, jax.random.key(0))
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, prompt_len)).astype(np.int32)
    j_outs, j_toks, j_cache = _run_jax(jcfg, jparams, prompts)

    model = bridge.params_from_jax(_np(jparams), cfg, device="cpu")
    forced = None if dtype == "float32" else j_toks
    t_outs, t_toks, t_cache = _run_port(cfg, model, prompts, forced)

    if dtype == "float32":
        np.testing.assert_array_equal(t_toks, j_toks)
        for (tl, tv), (jl, jv) in zip(t_outs, j_outs):
            np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(tv.numpy(), jv, atol=1e-4, rtol=1e-4)
        for tc, jc in zip(t_cache, bridge.cache_from_jax(j_cache, cfg)):
            for name in ("k", "v"):
                assert tc[name].dtype == jc[name].dtype
                np.testing.assert_allclose(tc[name].numpy(),
                                           jc[name].numpy(),
                                           atol=1e-4, rtol=1e-4)
    else:
        for (tl, tv), (jl, jv) in zip(t_outs, j_outs):
            assert _rel(tl.numpy(), jl) < 5e-2
            assert np.abs(tv.numpy() - jv).max() <= 5e-2
        for tc, jc in zip(t_cache, bridge.cache_from_jax(j_cache, cfg)):
            for name in ("k", "v"):
                assert tc[name].dtype == jc[name].dtype == torch.bfloat16
                assert _rel(tc[name].float().numpy(),
                            jc[name].float().numpy()) < 5e-2


def test_bridge_keeps_dtypes_and_layers():
    jcfg, cfg = _cfgs("bfloat16", True)
    jparams = _np(jbackbone.init_params(jcfg, jax.random.key(3)))
    model = bridge.params_from_jax(jparams, cfg, device="cpu")
    assert len(model.layers) == cfg.n_layers
    assert model.embed.dtype == torch.bfloat16
    assert model.value_head.dtype == torch.float32
    assert model.layers[0].norm1.scale.dtype == torch.float32
    wq1 = jparams["blocks"]["l0"]["mixer"]["wq"][1]
    np.testing.assert_array_equal(
        model.layers[1].mixer.wq.detach().float().numpy(),
        wq1.astype(np.float32))


def test_launcher_main_in_process(capsys):
    argv = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "12", "--gen", "5"]
    greedy = serve.main(argv)
    assert greedy.tokens.shape == (2, 5)
    assert greedy.cfg.use_pallas_attention
    assert torch.isfinite(greedy.prefill_logits).all()
    assert greedy.prefill_logits.shape == (2, greedy.cfg.vocab_size)
    s1 = serve.main(argv + ["--temperature", "1.0", "--seed", "7"])
    s2 = serve.main(argv + ["--temperature", "1.0", "--seed", "7"])
    torch.testing.assert_close(s1.tokens, s2.tokens, rtol=0, atol=0)
    # the greedy launcher run equals prefill + serve steps driven by hand
    _, toks, _, _ = serve.generate(greedy.model, greedy.cfg, greedy.prompts,
                                   5)
    torch.testing.assert_close(toks, greedy.tokens, rtol=0, atol=0)
    assert "prefill 2x12" in capsys.readouterr().out


def test_launcher_spec_mode_not_ported():
    """The ``--spec`` policy-serving mode is ported (ROADMAP queue 1, item
    6) where it raised: it serves the spec's policy under the load
    generator and returns the metrics it prints."""
    metrics = serve.main(["--spec", "examples/specs/quickstart.json",
                          "--requests", "20", "--rate", "4000",
                          "--device", "cpu"])
    assert metrics["serve_shed"] == 0 and metrics["serve_qps"] > 0
