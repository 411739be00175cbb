"""Stand-ins for every model input, on ``device="meta"`` (no allocation).

Counterpart of ``repro/launch/specs.py``. The input specs of the step a
shape exercises:

  train_4k     -> train_step(dg_state, batch)
  prefill_32k  -> prefill_step(params, batch)
  decode_32k   -> serve_step(params, token, cache, pos, extras)
  long_500k    -> serve_step, B=1, 512k cache (sub-quadratic archs only)

Modality frontends are stubbed as in the reference: Whisper gets frame
embeddings (train/prefill) or encoder output (decode); Qwen2-VL gets
patch embeddings and M-RoPE position ids. ``launch/dryrun.py`` turns
these into tensors of the same shapes and dtypes on its fake device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import backbone


class ShapeSpec(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def supports(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False
    return True


def skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention architecture: 512k decode requires a "
                "sub-quadratic or sliding-window variant (DESIGN.md "
                "§Arch-applicability)")
    return None


def _extras(cfg: ModelConfig, B: int, S: int, decode: bool) -> dict:
    ex = {}
    bf16 = torch.bfloat16
    if cfg.mrope:
        shp = (3, B, 1) if decode else (3, B, S)
        ex["mrope_positions"] = _sds(shp, torch.int32)
    if cfg.vision_prefix and not decode:
        ex["patch_embeds"] = _sds((B, cfg.vision_prefix, cfg.d_model), bf16)
    if cfg.is_encoder_decoder:
        if decode:
            ex["enc_out"] = _sds((B, cfg.enc_seq, cfg.d_model), bf16)
        else:
            ex["audio_embeds"] = _sds((B, cfg.enc_seq, cfg.d_model), bf16)
    return ex


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _sds((B, S), torch.int32),
        "actions": _sds((B, S), torch.int32),
        "advantages": _sds((B, S), torch.float32),
        "returns": _sds((B, S), torch.float32),
        "behavior_logprob": _sds((B, S), torch.float32),
        "loss_mask": _sds((B, S), torch.float32),
    }
    batch.update(_extras(cfg, B, S, decode=False))
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((B, S), torch.int32)}
    batch.update(_extras(cfg, B, S, decode=False))
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(token (B, 1), cache (one dict per layer), pos (), extras)."""
    B, S = shape.global_batch, shape.seq_len
    cache = backbone.init_decode_cache(cfg, B, S, device="meta")
    token = _sds((B, 1), torch.int32)
    pos = _sds((), torch.int32)
    extras = _extras(cfg, B, S, decode=True)
    return token, cache, pos, extras
