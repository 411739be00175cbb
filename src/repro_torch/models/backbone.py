"""Decoder / encoder-decoder backbone: embed, a stack of decoder layers,
final norm, LM and value heads; for an encoder-decoder also an encoder
and a cross-attention sublayer in every decoder layer.

Counterpart of ``repro/models/backbone.py`` for ATTN_FULL, ATTN_LOCAL,
RGLRU and RWKV mixers with the dense or the MoE FFN (``models/moe.py``,
``moe_dropless.py``), Whisper's encoder and cross-attention, and
Qwen2-VL's M-RoPE and vision prefix. The modality frontends are stubs, as
in the reference: ``audio_embeds`` (B, enc_seq, d) are the encoder's
input (``run_encoder``; its output ``enc_out`` is what every decoder
layer's cross-attention reads), and ``patch_embeds`` (B, vision_prefix,
d) overwrite the first ``vision_prefix`` embedded positions. The
reference stacks each mixer/ffn cycle's params under ``blocks/l<i>``,
scans over them and runs the left-over layers (``rem``) unrolled; here
each layer is one ``DecoderLayer`` in an ``nn.ModuleList`` (``bridge.py``
unstacks; the encoder's layers likewise under ``encoder.layers``), so
the cycle exists only in the bridge. Modules hold the weights; the config
is passed on each call, as the reference passes it beside the params, so
one set of weights can run with and without the kernels.

Entry points: ``forward`` (full sequence, optionally filling caches, or
for training with ``remat=True``: one ``torch.utils.checkpoint`` per
layer, the counterpart of the reference's ``jax.checkpoint`` per block),
``prefill`` and ``decode_step``; ``init_params`` builds the model on the
device from a ``torch.Generator``. ``forward`` returns the MoE layers'
load-balance loss summed over layers as its third value (0 with a cache,
as in the reference). ``Backbone.forward`` is ``forward``'s hidden states
and that loss, so ``torch.func.functional_call`` runs the model on a flat
``{name: tensor}`` dict (the learner's params); ``from_params`` wraps
such a dict in a module without copying; ``param_count`` counts a
config's parameters without allocating them (the counterpart of
``abstract_params``).
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import (ATTN_FULL, ATTN_LOCAL, FFN_DENSE,
                                      FFN_MOE, RGLRU, RWKV, ModelConfig)
from repro_torch.kernels import is_dtensor
from repro_torch.launch.mesh import active_mesh
from repro_torch.models import attention, layers, moe, rglru, rwkv6
from repro_torch.sharding.constraints import constrain, gather_fsdp


class DecoderLayer(nn.Module):
    """One layer (``backbone.py:_init_layer``, ``_apply_layer``); with
    ``cross`` also ``norm_x`` and the cross-attention ``xattn``."""

    def __init__(self, cfg: ModelConfig, mixer_kind: str,
                 ffn_kind: str = FFN_DENSE, cross: bool = False,
                 device=None):
        super().__init__()
        self.mixer_kind = mixer_kind
        self.norm1 = layers.Norm(cfg, cfg.d_model, device=device)
        if mixer_kind == RGLRU:
            self.mixer = rglru.RGLRU(cfg, device=device)
        elif mixer_kind == RWKV:
            self.mixer = rwkv6.RWKV6(cfg, device=device)
        else:
            self.mixer = attention.Attention(cfg, device=device)
        self.norm2 = layers.Norm(cfg, cfg.d_model, device=device)
        self.ffn = (moe.MoE(cfg, device=device) if ffn_kind == FFN_MOE
                    else layers.MLP(cfg, device=device))
        if cross:
            self.norm_x = layers.Norm(cfg, cfg.d_model, device=device)
            self.xattn = attention.Attention(cfg, device=device)
        else:
            self.xattn = None

    def forward(self, x, cfg: ModelConfig, *, positions=None,
                mrope_positions=None, causal: bool = True, cache=None,
                cache_pos=None, enc_out=None):
        """(x, cache, aux): aux is the MoE's load-balance loss, None for
        the dense FFN. The cross-attention runs when the layer has one
        and ``enc_out`` is given, as in the reference.

        Each sublayer's input is constrained to whole sequences
        (``_sublayer_input``): with the residual split over ``model`` on
        its sequence dim (sequence parallelism), the sublayer gathers it
        first, as Megatron's does; the identity without a mesh."""
        h = _sublayer_input(self.norm1(x))
        if self.mixer_kind == RGLRU:
            out, cache = rglru.apply_rglru_block(self.mixer, h, cfg, cache)
        elif self.mixer_kind == RWKV:
            out, cache = rwkv6.apply_rwkv6_block(self.mixer, h, cfg, cache)
        else:
            out, cache = self.mixer(h, cfg, mixer_kind=self.mixer_kind,
                                    positions=positions,
                                    mrope_positions=mrope_positions,
                                    causal=causal, cache=cache,
                                    cache_pos=cache_pos)
        x = x + _sublayer_output(out)
        if self.xattn is not None and enc_out is not None:
            h = _sublayer_input(self.norm_x(x))
            out, _ = self.xattn(h, cfg, mixer_kind=ATTN_FULL, causal=False,
                                kv_override=enc_out)
            x = x + _sublayer_output(out)
        h = _sublayer_input(self.norm2(x))
        if isinstance(self.ffn, moe.MoE):
            out, aux = self.ffn(h, cfg)
        else:
            out, aux = self.ffn(h), None
        return x + _sublayer_output(out), cache, aux


class _WholeSeqGrad(torch.autograd.Function):
    """The identity, whose gradient is split on the batch only: a
    sublayer's output joins a residual split on its sequence dim too, and
    without this its gradient would come back split there, where the
    product's backward cannot merge (B, S)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate, Shard
        ctx.mesh = y.device_mesh
        ctx.placements = tuple(
            p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def _sublayer_output(y):
    return _WholeSeqGrad.apply(y) if is_dtensor(y) else y


def _sublayer_input(h):
    """``h`` split on the batch only: a DTensor cannot merge (B, S) for a
    product while S is split (the reference leaves that to GSPMD)."""
    return constrain(h, "batch", None, None)


class Encoder(nn.Module):
    """Whisper's encoder (``params["encoder"]``, ``backbone.py:154-163``):
    ``n_enc_layers`` full-attention layers with the dense FFN, no cross,
    and a final norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, ATTN_FULL, FFN_DENSE, device=device)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = layers.Norm(cfg, cfg.d_model, device=device)


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = layers.cdtype(cfg)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=dt, device=device))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, mixer, ffn, cross=cfg.is_encoder_decoder,
                         device=device)
            for mixer, ffn in cfg.layer_kinds)
        self.final_norm = layers.Norm(cfg, cfg.d_model, device=device)
        self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size,
                                                dtype=dt, device=device))
        self.value_head = nn.Parameter(torch.zeros(cfg.d_model, 1,
                                                   dtype=torch.float32,
                                                   device=device))
        self.encoder = (Encoder(cfg, device=device)
                        if cfg.is_encoder_decoder else None)

    def forward(self, cfg: ModelConfig, tokens, positions=None,
                remat: bool = False, mrope_positions=None,
                patch_embeds=None, audio_embeds=None):
        """(the final hidden states (B, S, D) of a full sequence, the
        summed load-balance loss)."""
        hidden, _, aux = forward(self, cfg, tokens, positions=positions,
                                 mrope_positions=mrope_positions,
                                 patch_embeds=patch_embeds,
                                 audio_embeds=audio_embeds, remat=remat)
        return hidden, aux


def from_params(cfg: ModelConfig, params: dict) -> Backbone:
    """A ``Backbone`` whose weights are the tensors of ``params`` (a flat
    ``{name: tensor}`` dict, as ``named_parameters`` names them), shared,
    not copied."""
    model = Backbone(cfg, device="meta")
    model.load_state_dict(params, assign=True)
    return model


def param_count(cfg: ModelConfig) -> int:
    return sum(p.numel() for p in Backbone(cfg, device="meta").parameters())


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Backbone:
    """Random weights drawn directly on ``device`` (the generator must
    live there too), one tensor at a time; norms start at scale 1 and
    bias 0 and the value head at 0, as in the reference. The numbers
    differ from the reference's ``jax.random`` ones: tests carry JAX
    weights across with ``bridge.params_from_jax``."""
    model = Backbone(cfg, device=device)
    layers.normal_(model.embed, generator, cfg.d_model ** -0.5)
    enc = [] if model.encoder is None else list(model.encoder.layers)
    for layer in [*model.layers, *enc]:
        layer.mixer.init_weights(generator)
        if layer.xattn is not None:
            layer.xattn.init_weights(generator)
        layer.ffn.init_weights(generator)
    layers.normal_(model.lm_head, generator, cfg.d_model ** -0.5)
    return model


def _init_layer_cache(cfg: ModelConfig, mixer_kind: str, batch: int,
                      max_len: int, device=None) -> dict:
    if mixer_kind == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, device=device)
    if mixer_kind == RWKV:
        return rwkv6.init_rwkv6_cache(cfg, batch, device=device)
    return attention.init_cache(
        cfg, batch, max_len, device=device,
        window=cfg.window if mixer_kind == ATTN_LOCAL else 0)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> list:
    """One dict per layer: ``{"k", "v"}`` for attention, ``{"h", "conv"}``
    for RG-LRU, ``{"state", "xprev"}`` for RWKV-6."""
    return [_init_layer_cache(cfg, mixer, batch, max_len, device=device)
            for mixer, _ in cfg.layer_kinds]


def _remat_layer(layer: DecoderLayer, x, cfg: ModelConfig, kw: dict):
    """One layer under ``torch.utils.checkpoint``: the backward runs it
    again instead of keeping its intermediates. Its weights go in as
    arguments, so the recompute sees them even when the caller swapped
    them in with ``functional_call`` and has swapped them out since; so
    does ``enc_out``, which carries gradient back to the encoder.
    Returns (x, aux), as the reference's remat'd block carries aux out."""
    names, weights = zip(*layer.named_parameters())
    kw = dict(kw)
    enc_out = kw.pop("enc_out", None)

    def run(x, enc, *ws):
        # on a mesh the layer's weights are gathered here, inside the
        # checkpoint: again at the recompute, never kept
        ws = [gather_fsdp(w) for w in ws]
        x, _, aux = torch.func.functional_call(
            layer, dict(zip(names, ws)), (x, cfg), {**kw, "enc_out": enc})
        return x, aux

    return torch.utils.checkpoint.checkpoint(run, x, enc_out, *weights,
                                             use_reentrant=False)


def run_encoder(model: Backbone, cfg: ModelConfig, audio_embeds):
    """Whisper's encoder over frame embeddings (B, enc_seq, d) in the
    model dtype: non-causal self-attention with RoPE at the default
    positions, then the final norm (``backbone.py:192-201``)."""
    x = audio_embeds.to(layers.cdtype(cfg))
    for layer in model.encoder.layers:
        x, _, _ = _call_layer(layer, x, cfg, causal=False)
    return model.encoder.final_norm(x)


def _call_layer(layer, x, cfg: ModelConfig, **kw):
    """``layer(x, cfg, **kw)``; with ``DTensor`` weights on a mesh, run
    on its weights gathered over the data axes (``gather_fsdp``)."""
    if active_mesh() is None:
        return layer(x, cfg, **kw)
    ws = {n: gather_fsdp(w) for n, w in layer.named_parameters()}
    return torch.func.functional_call(layer, ws, (x, cfg), kw)


def _embed_inputs(model: Backbone, cfg: ModelConfig, tokens, patch_embeds):
    """The token embeddings; ``patch_embeds`` (B, P, d) overwrite the
    first P positions, not prepended (``backbone.py:204-210``)."""
    x = layers.apply_embed(model.embed, tokens) * math.sqrt(cfg.d_model)
    x = x.to(layers.cdtype(cfg))
    if cfg.vision_prefix and patch_embeds is not None:
        P = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def forward(model: Backbone, cfg: ModelConfig, tokens, *, positions=None,
            mrope_positions=None, patch_embeds=None, audio_embeds=None,
            enc_out=None, cache=None, cache_pos=None, remat: bool = False):
    """Full sequence (cache None), prefill (cache given, S > 1) or decode
    (cache given, S == 1, cache_pos given). Returns (hidden, cache, aux):
    aux the MoE layers' load-balance loss summed over layers, fp32, and 0
    when a cache is given, as in the reference. ``remat`` (full sequence
    only): checkpoint every decoder layer. An encoder-decoder runs its
    encoder on ``audio_embeds`` unless ``enc_out`` is given.

    Each layer's returned cache replaces its entry in the caller's list:
    attention writes its k/v in place and returns the same dict, the
    recurrent mixers return new state."""
    if remat and cache is not None:
        raise ValueError("remat applies to a full-sequence forward (no "
                         "cache)")
    if enc_out is None and cfg.is_encoder_decoder and audio_embeds is not None:
        enc_out = run_encoder(model, cfg, audio_embeds)
    x = constrain(_embed_inputs(model, cfg, tokens, patch_embeds),
                  "batch", "seq_model", None)
    kw = dict(positions=positions, mrope_positions=mrope_positions,
              enc_out=enc_out)
    aux = torch.zeros((), device=x.device)
    for i, layer in enumerate(model.layers):
        if i % cfg.cycle_len == 0:
            # the residual's layout at each block (one mixer/ffn cycle)
            x = constrain(x, "batch", "seq_model", None)
        if remat:
            x, a = _remat_layer(layer, x, cfg, kw)
        else:
            x, new, a = _call_layer(
                layer, x, cfg, cache=None if cache is None else cache[i],
                cache_pos=cache_pos, **kw)
            if cache is not None:
                cache[i] = new
        if a is not None and cache is None:
            aux = aux + a
    return model.final_norm(x), cache, aux


def logits_and_value(model: Backbone, cfg: ModelConfig, hidden):
    """(logits (B, S, V) fp32, value (B, S) fp32): the LM head runs in the
    model dtype and is then widened, as in the reference."""
    logits = (hidden @ gather_fsdp(model.lm_head)).float()
    logits = layers.softcap(logits, cfg.final_softcap)
    value = (hidden.float() @ gather_fsdp(model.value_head))[..., 0]
    return logits, value


def prefill(model: Backbone, cfg: ModelConfig, tokens, max_len: int,
            cache=None, **kw):
    """Build decode caches from a full prompt; ``kw`` goes to ``forward``
    (positions, mrope_positions, patch_embeds, audio_embeds, enc_out).
    ``cache``: the empty caches to fill (``init_decode_cache``'s, made
    here when None). Returns (logits_last (B, V), value_last (B,),
    cache)."""
    B, _ = tokens.shape
    if cache is None:
        cache = init_decode_cache(cfg, B, max_len, device=tokens.device)
    hidden, cache, _ = forward(model, cfg, tokens, cache=cache, **kw)
    hidden = _sublayer_input(hidden)
    logits, value = logits_and_value(model, cfg, hidden[:, -1:])
    return logits[:, 0], value[:, 0], cache


def decode_step(model: Backbone, cfg: ModelConfig, token, cache, pos: int,
                *, mrope_positions=None, audio_embeds=None, enc_out=None):
    """token: (B, 1) int; pos: position of ``token``; ``mrope_positions``
    (3, B, 1), ``enc_out`` (B, enc_seq, d) the encoder states the
    cross-attention reads (or ``audio_embeds`` to encode again). Returns
    (logits (B, V), value (B,), cache), the cache list updated in place."""
    B = token.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long,
                           device=token.device)
    hidden, cache, _ = forward(model, cfg, token, positions=positions,
                               mrope_positions=mrope_positions,
                               audio_embeds=audio_embeds, enc_out=enc_out,
                               cache=cache, cache_pos=pos)
    logits, value = logits_and_value(model, cfg, hidden)
    return logits[:, 0], value[:, 0], cache
