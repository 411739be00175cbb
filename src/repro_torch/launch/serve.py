"""Serving launcher, LLM decode mode: batched prefill, then one-token
serve steps.

Counterpart of ``repro/launch/serve.py`` (the ``--arch`` mode), with the
same flags and schedule plus ``--device`` (default ``cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        --batch 4 --prompt-len 500 --gen 32

``--arch`` is one of the port's registered configs: ``starcoder2-3b``,
``recurrentgemma-9b``, ``rwkv6-7b``. Prefill runs full-sequence attention
through the hand-written flash kernel and the RG-LRU and RWKV-6
recurrences through the lru_scan and wkv6 kernels (wkv6 also runs each
decode step): ``use_pallas_attention``, the port's one kernel switch, is
turned on, as the reference's config says the field exists for prefill
and serving. Sampling at step i keys on (seed, row, i), the same
determinism contract as the RL actors. Weights are random, drawn on the
device from a seeded generator.

``main(argv)`` can be called in-process and returns a ``ServeResult``.
The ``--spec`` policy-serving mode waits for the RL slices.
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


@torch.inference_mode()
def generate(model, cfg: ModelConfig, prompts, gen: int,
             temperature: float = 0.0, seed: int = 0):
    """Prefill, pick at step 0, then decode at position S + i
    (``launch/serve.py:116-135``). Returns (prefill_logits, tokens,
    prefill_s, decode_s)."""
    device = prompts.device
    B, S = prompts.shape
    master = determinism.master_key(seed, device=device)
    rows = torch.arange(B, device=device)

    def pick(logits, step):
        if temperature <= 0:
            return torch.argmax(logits, -1)
        keys = determinism.obs_keys(master, rows, step)
        return determinism.sample_action(keys, logits / temperature)

    _sync(device)
    t0 = time.perf_counter()
    logits, _, cache = backbone.prefill(model, cfg, prompts, S + gen)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits

    serve = learner.make_serve_step(cfg)
    tok = pick(logits, 0)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, _, cache = serve(model, tok[:, None], cache, S + i)
        tok = pick(logits, i + 1)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return prefill_logits, torch.stack(out, dim=1), prefill_s, decode_s


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="policy-as-a-service mode (not ported yet)")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap.parse_args(argv)


def main(argv=None) -> ServeResult:
    args = parse_args(argv)
    if args.spec:
        raise NotImplementedError(
            "--spec policy serving is not ported yet: it waits for the RL "
            "slices (ROADMAP queue 1 items 2-13)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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
