"""Carry JAX-side trees (as numpy) into the port's modules and layouts.

All layout conversion between the two packages lives here. The reference
stacks the params of each mixer/ffn cycle under ``blocks/l<i>`` with a
leading block axis (``jax.vmap(init_block)``) and keeps left-over layers
in ``rem`` (RecurrentGemma's 38 = 12 * 3 + 2); the port keeps one
``DecoderLayer`` per layer. Leaves keep their dtype: bf16 stays bf16; norm
scales, the value head, the RG-LRU gates (``w_a``, ``w_i``, biases,
``lambda_param``, ``conv_b``) and the RWKV-6 ``mu``, ``w0``,
``w_lora_*``, ``u`` and ``ln_scale`` stay fp32. Every leaf keeps its
layout: the port's recurrent mixers use the reference's.

Takes numpy arrays only (``jax.tree.map(np.asarray, params)`` on the
JAX side), so this module needs neither ``jax`` nor ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import backbone


def to_torch(a, device=None) -> torch.Tensor:
    """numpy array -> tensor of the same dtype; bf16 (ml_dtypes) arrays go
    through their uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def unstack_layers(tree: dict, cfg: ModelConfig) -> list:
    """{"blocks": {"l<i>": stacked}, "rem": [...]} -> one subtree per layer,
    in layer order. Works for params and decode caches alike."""
    cyc = cfg.cycle_len
    n_blocks = cfg.n_layers // cyc
    out = []
    for b in range(n_blocks):
        for i in range(cyc):
            out.append(_index(tree["blocks"][f"l{i}"], b))
    out.extend(tree.get("rem", []))
    if len(out) != cfg.n_layers:
        raise ValueError(f"tree holds {len(out)} layers, config "
                         f"{cfg.name} has {cfg.n_layers}")
    return out


def _index(tree, b):
    if isinstance(tree, dict):
        return {k: _index(v, b) for k, v in tree.items()}
    return tree[b]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device=None) -> backbone.Backbone:
    """The reference's ``backbone.init_params`` tree (numpy leaves) ->
    the port's ``Backbone`` on ``device`` with the same weights."""
    state = {"embed": tree["embed"]["table"],
             "lm_head": tree["lm_head"],
             "value_head": tree["value_head"]}
    state.update(_flatten(tree["final_norm"], "final_norm."))
    for n, layer in enumerate(unstack_layers(tree, cfg)):
        state.update(_flatten(layer, f"layers.{n}."))
    model = backbone.Backbone(cfg, device="meta")
    expected = model.state_dict()
    if set(state) != set(expected):
        raise ValueError("param trees differ: missing "
                         f"{sorted(set(expected) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(expected))}")
    tensors = {}
    for name, ref in expected.items():
        t = to_torch(state[name], device)
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, the "
                             f"port expects {tuple(ref.shape)} {ref.dtype}")
        tensors[name] = t
    model.load_state_dict(tensors, assign=True)
    return model


def cache_from_jax(tree: dict, cfg: ModelConfig, device=None) -> list:
    """The reference's decode cache tree -> the port's per-layer list."""
    return [{k: to_torch(v, device) for k, v in layer.items()}
            for layer in unstack_layers(tree, cfg)]
