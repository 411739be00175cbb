"""Serving launcher, two modes.

**Policy-as-a-service** (``--spec``): serve an RL policy from an
ExperimentSpec through the continuous-batching ``PolicyServer``
(``repro_torch.serve``), loading the newest checkpoint capsule when the
spec (or ``--checkpoint``) names one, drive the open-loop Poisson load
generator against it and print p50/p99 latency and QPS::

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --spec examples/specs/quickstart.json --requests 500 --rate 2000

**LLM decode** (``--arch``): batched prefill, then one-token serve steps.
Counterpart of ``repro/launch/serve.py``, with the same flags and
schedule plus ``--device`` (default ``cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        --batch 4 --prompt-len 500 --gen 32

``--arch`` is one of the port's registered configs
(``configs.base.list_configs``): the dense decoders ``starcoder2-3b``,
``gemma2-27b``, ``h2o-danube-3-4b``, ``stablelm-12b``, the hybrids
``recurrentgemma-9b`` and ``rwkv6-7b``, the MoE decoders
``granite-moe-1b-a400m`` and ``llama4-scout-17b-a16e``, the
encoder-decoder ``whisper-medium`` and the VLM ``qwen2-vl-72b``. Their
modality inputs are the reference's stub (``launch/serve.py:98-131``):
zero ``audio_embeds`` at prefill and a zero ``enc_out`` at every decode
step (so decode does not see the encoder's output of the prompt's
audio), zero ``patch_embeds``, and M-RoPE positions ``arange(S)`` in all
three streams at prefill and ``S + i`` at decode step i. ``--n-layers``
cuts the depth, keeping the widths, as ``launch/train.py``'s does
(Llama-4-Scout's 48 layers do not fit one card; 4, one iRoPE cycle, do)::

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --n-layers 4 --batch 4 \
        --prompt-len 500 --gen 32

Prefill runs full-sequence attention
through the hand-written flash kernel and the RG-LRU and RWKV-6
recurrences through the lru_scan and wkv6 kernels (wkv6 also runs each
decode step): ``use_pallas_attention``, the port's one kernel switch, is
turned on, as the reference's config says the field exists for prefill
and serving. Sampling at step i keys on (seed, row, i), the same
determinism contract as the RL actors. Weights are random, drawn on the
device from a seeded generator.

``main(argv)`` can be called in-process: it returns a ``ServeResult``
in ``--arch`` mode and the load generator's metrics dict with ``--spec``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import determinism, learner
from repro_torch.models import backbone


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    model: backbone.Backbone
    prompts: torch.Tensor          # (B, S) int64
    prefill_logits: torch.Tensor   # (B, V) fp32, last prompt position
    tokens: torch.Tensor           # (B, G) int64, generated
    prefill_s: float
    decode_s: float

    @property
    def decode_tok_per_s(self) -> float:
        B, G = self.tokens.shape
        return B * (G - 1) / max(self.decode_s, 1e-9)


def build(cfg: ModelConfig, batch: int, prompt_len: int, device):
    """Random weights (generator seed 0) and prompts (seed 1) on device."""
    model = backbone.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    return model, prompts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_policy(args) -> dict:
    """--spec mode: build the session, serve it, drive the load gen."""
    from repro_torch import api
    from repro_torch.serve import loadgen
    spec = api.load(args.spec)
    if args.max_batch is not None:
        spec = spec.replace(serve={**spec.serve.canonical(),
                                   "max_batch": args.max_batch})
    print(f"# serving {spec.env.name} x {spec.policy.name} "
          f"(max_batch={spec.serve.max_batch}, "
          f"checkpoint={args.checkpoint or spec.checkpoint.dir or 'none'})",
          flush=True)
    metrics = loadgen.run(spec, requests=args.requests, rate=args.rate,
                          seed=args.seed, checkpoint=args.checkpoint,
                          device=args.device)
    for name, value in metrics.items():
        print(f"{name}={value:.6g}", flush=True)
    return metrics


def stub_inputs(cfg: ModelConfig, batch: int, prompt_len: int,
                device) -> dict:
    """The prefill's modality inputs of the reference's stub: zero audio
    and patch embeddings (in the model dtype, where the reference's are
    bf16: zeros either way), M-RoPE positions ``arange(S)`` in each of
    the three streams; {} for a text-only decoder."""
    dt = getattr(torch, cfg.dtype)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["audio_embeds"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                         dtype=dt, device=device)
    if cfg.vision_prefix:
        kw["patch_embeds"] = torch.zeros(
            (batch, cfg.vision_prefix, cfg.d_model), dtype=dt, device=device)
    if cfg.mrope:
        kw["mrope_positions"] = torch.arange(prompt_len, device=device) \
            .expand(3, batch, prompt_len)
    return kw


def decode_extras(cfg: ModelConfig, batch: int, pos: int, device,
                  enc_out=None) -> dict:
    """Decode step ``pos``'s extras: M-RoPE positions (3, B, 1) at
    ``pos``, and ``enc_out`` (the stub's zeros unless given)."""
    extras = {}
    if cfg.mrope:
        extras["mrope_positions"] = torch.full((3, batch, 1), pos,
                                               device=device)
    if cfg.is_encoder_decoder:
        extras["enc_out"] = enc_out if enc_out is not None else torch.zeros(
            (batch, cfg.enc_seq, cfg.d_model), dtype=getattr(torch, cfg.dtype),
            device=device)
    return extras


@torch.inference_mode()
def generate(model, cfg: ModelConfig, prompts, gen: int,
             temperature: float = 0.0, seed: int = 0, audio_embeds=None,
             patch_embeds=None):
    """Prefill, pick at step 0, then decode at position S + i
    (``launch/serve.py:116-135``). Returns (prefill_logits, tokens,
    prefill_s, decode_s). The modality inputs are the stub's
    (``stub_inputs``, ``decode_extras``) unless ``audio_embeds`` or
    ``patch_embeds`` are given: then the encoder runs once on
    ``audio_embeds`` and its output feeds the prefill's and every decode
    step's cross-attention."""
    device = prompts.device
    B, S = prompts.shape
    kw = stub_inputs(cfg, B, S, device)
    if patch_embeds is not None:
        kw["patch_embeds"] = patch_embeds
    enc_out = None
    master = determinism.master_key(seed, device=device)
    rows = torch.arange(B, device=device)

    def pick(logits, step):
        if temperature <= 0:
            return torch.argmax(logits, -1)
        keys = determinism.obs_keys(master, rows, step)
        return determinism.sample_action(keys, logits / temperature)

    _sync(device)
    t0 = time.perf_counter()
    if audio_embeds is not None:
        kw.pop("audio_embeds", None)
        kw["enc_out"] = enc_out = backbone.run_encoder(model, cfg,
                                                       audio_embeds)
    logits, _, cache = backbone.prefill(model, cfg, prompts, S + gen, **kw)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits

    serve = learner.make_serve_step(cfg)
    tok = pick(logits, 0)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, _, cache = serve(model, tok[:, None], cache, S + i,
                                 decode_extras(cfg, B, S + i, device,
                                               enc_out))
        tok = pick(logits, i + 1)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return prefill_logits, torch.stack(out, dim=1), prefill_s, decode_s


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="serve an RL policy from this ExperimentSpec "
                    "JSON (policy-as-a-service mode)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="with --spec: TrainState capsule base path "
                    "(default: latest under the spec's checkpoint dir, "
                    "else initial params)")
    ap.add_argument("--requests", type=int, default=500,
                    help="with --spec: load-generator request count")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="with --spec: offered load, req/s")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="with --spec: override the spec's serve.max_batch")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.spec:
        return serve_policy(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    cfg = dataclasses.replace(cfg, use_pallas_attention=True)
    B, S, G = args.batch, args.prompt_len, args.gen

    model, prompts = build(cfg, B, S, device)
    logits, tokens, prefill_s, decode_s = generate(
        model, cfg, prompts, G, args.temperature, args.seed)
    res = ServeResult(cfg, model, prompts, logits, tokens, prefill_s,
                      decode_s)
    print(f"prefill {B}x{S}: {prefill_s:.4f}s")
    print(f"decode {G - 1} steps: {decode_s:.4f}s "
          f"({res.decode_tok_per_s:.1f} tok/s)")
    print("generated:", tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
