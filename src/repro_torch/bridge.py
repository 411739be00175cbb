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

The small policies' params (``models/cnn_policy.py``) are flat dicts;
the CNN's conv kernels go from the reference's HWIO to the port's OIHW
(``policy_params_from_jax``), the one layout change of the RL slice. A
``DelayedGradState``, its optimizer state and an env state carry over
leaf by leaf (``delayed_grad_from_jax``, ``env_state_from_jax``), a
whole continuation capsule too (``train_state_from_jax``), and
``tree_leaves`` flattens a tree in ``jax.tree_util`` order. The way back,
``train_state_to_reference``, gives a capsule's numpy leaves in the
reference's layout: what the checkpoints hold.

The backbone's params are a flat ``{name: tensor}`` dict in the port
(``Backbone.named_parameters``); ``backbone_params_from_jax`` unstacks
the reference's tree into it and ``backbone_params_to_reference`` stacks
it back, and ``backbone_state_*`` carry a whole backbone
``DelayedGradState`` (params, params_prev, the Adam or RMSProp moments,
step) both ways, so checkpoints keep the reference's treedef.

Takes numpy arrays only (``jax.tree.map(np.asarray, params)`` on the
JAX side), so this module needs neither ``jax`` nor ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import delayed_grad
from repro_torch.core.tree import tree_leaves  # noqa: F401 (re-export)
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


def _as_tensor(x, device=None) -> torch.Tensor:
    """A numpy array (bf16 through ``to_torch``) or a tensor, on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return to_torch(x, device)


def backbone_params_from_jax(tree: dict, cfg: ModelConfig, device=None,
                             moments: bool = False) -> dict:
    """The reference's ``backbone.init_params`` tree (numpy or tensor
    leaves) -> the port's flat ``{name: tensor}`` params on ``device``,
    in ``Backbone.named_parameters`` order, shapes and dtypes checked
    (``moments``: a params-shaped optimizer moment, fp32 throughout)."""
    state = {"embed": tree["embed"]["table"],
             "lm_head": tree["lm_head"],
             "value_head": tree["value_head"]}
    state.update(_flatten(tree["final_norm"], "final_norm."))
    for n, layer in enumerate(unstack_layers(tree, cfg)):
        state.update(_flatten(layer, f"layers.{n}."))
    expected = backbone.Backbone(cfg, device="meta").state_dict()
    if set(state) != set(expected):
        raise ValueError("param trees differ: missing "
                         f"{sorted(set(expected) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(expected))}")
    out = {}
    for name, ref in expected.items():
        t = _as_tensor(state[name], device)
        dtype = torch.float32 if moments else ref.dtype
        if t.shape != ref.shape or t.dtype != dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, the "
                             f"port expects {tuple(ref.shape)} {dtype}")
        out[name] = t
    return out


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device=None) -> backbone.Backbone:
    """The reference's ``backbone.init_params`` tree (numpy leaves) ->
    the port's ``Backbone`` on ``device`` with the same weights."""
    return backbone.from_params(cfg,
                                backbone_params_from_jax(tree, cfg, device))


def _nest(flat: dict) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def backbone_params_to_reference(params: dict, cfg: ModelConfig) -> dict:
    """The inverse of ``backbone_params_from_jax``: the flat params (any
    device, meta included) in the reference's tree, each cycle position's
    layers stacked under ``blocks/l<i>`` (block axis first) and the
    left-over layers in ``rem``. Leaves stay tensors of their dtype (bf16
    too; ``checkpoint.io`` stores it as the reference does)."""
    layers_ = [_nest({k[len(f"layers.{n}."):]: v for k, v in params.items()
                      if k.startswith(f"layers.{n}.")})
               for n in range(cfg.n_layers)]
    cyc = cfg.cycle_len
    n_blocks = cfg.n_layers // cyc

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    tree = {"embed": {"table": params["embed"]},
            "blocks": {f"l{i}": stack([layers_[b * cyc + i]
                                       for b in range(n_blocks)])
                       for i in range(cyc)},
            "final_norm": _nest({k[len("final_norm."):]: v
                                 for k, v in params.items()
                                 if k.startswith("final_norm.")}),
            "lm_head": params["lm_head"],
            "value_head": params["value_head"]}
    if n_blocks * cyc < cfg.n_layers:
        tree["rem"] = layers_[n_blocks * cyc:]
    return tree


def _map_backbone_state(dg, fn):
    """``fn(tree, moments)`` over every params-shaped tree of a backbone
    ``DelayedGradState`` (params, params_prev, and the optimizer's
    moments with ``moments=True``); other leaves (adam's ``t``,
    ``step``) as they are."""
    def opt(st):
        if isinstance(st, dict):
            return {k: fn(v, True) if isinstance(v, dict) else v
                    for k, v in st.items()}
        return st
    params, prev, opt_state, step = dg
    return delayed_grad.DelayedGradState(fn(params, False), fn(prev, False),
                                         opt(opt_state), step)


def backbone_state_to_reference(dg, cfg: ModelConfig):
    """A backbone ``DelayedGradState`` in the reference's layout (what
    ``launch/train.py`` checkpoints): tensor leaves, params-shaped trees
    stacked by ``backbone_params_to_reference``."""
    return _map_backbone_state(
        dg, lambda t, _: backbone_params_to_reference(t, cfg))


def backbone_state_from_jax(dg, cfg: ModelConfig, device=None):
    """The inverse: a reference backbone ``DelayedGradState`` (numpy or
    tensor leaves) as the port's, on ``device``."""
    out = _map_backbone_state(
        dg, lambda t, m: backbone_params_from_jax(t, cfg, device, m))
    opt_state = out.opt_state
    if isinstance(opt_state, dict):
        opt_state = {k: v if isinstance(v, dict) else _as_tensor(v, device)
                     for k, v in opt_state.items()}
    return out._replace(opt_state=opt_state,
                        step=_as_tensor(out.step, device).to(torch.int32))


def cache_from_jax(tree: dict, cfg: ModelConfig, device=None) -> list:
    """The reference's decode cache tree -> the port's per-layer list."""
    return [{k: to_torch(v, device) for k, v in layer.items()}
            for layer in unstack_layers(tree, cfg)]


# ------------------------------------------------------ the RL slice
def _is_conv_kernel(name: str) -> bool:
    return name.startswith("conv") and name.endswith("_w")


def _hwio_to_oihw(a):
    """(..., H, W, I, O) -> (..., O, I, H, W): a leading ring axis, where
    there is one, stays in front."""
    nd = a.ndim
    return np.ascontiguousarray(
        np.transpose(a, tuple(range(nd - 4)) + (nd - 1, nd - 2, nd - 4,
                                                nd - 3)))


def policy_params_from_jax(tree: dict, device=None) -> dict:
    """A small policy's flat params dict (mlp, cnn, token), or any flat
    dict shaped like one (an optimizer's per-param state, a behavior
    ring), from numpy leaves. ``conv<i>_w`` leaves go HWIO -> OIHW."""
    return {k: to_torch(_hwio_to_oihw(np.asarray(v)) if _is_conv_kernel(k)
                        else v, device)
            for k, v in tree.items()}


def _oihw_to_hwio(a):
    """The inverse of ``_hwio_to_oihw``: (..., O, I, H, W) -> (..., H, W,
    I, O)."""
    nd = a.ndim
    return np.ascontiguousarray(
        np.transpose(a, tuple(range(nd - 4)) + (nd - 2, nd - 1, nd - 3,
                                                nd - 4)))


def _map_params_like(tree, flat_fn, leaf_fn):
    """``flat_fn`` over every dict of params-shaped leaves (params, a
    ring, optimizer moments), ``leaf_fn`` over every other leaf."""
    if isinstance(tree, dict):
        if all(not isinstance(v, (dict, tuple, list)) for v in tree.values()):
            return flat_fn(tree)
        return {k: _map_params_like(v, flat_fn, leaf_fn)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_params_like(v, flat_fn, leaf_fn)
                            for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_params_like(v, flat_fn, leaf_fn) for v in tree)
    return leaf_fn(tree)


def _params_like(tree, device):
    return _map_params_like(tree,
                            lambda d: policy_params_from_jax(d, device),
                            lambda x: to_torch(x, device))


def opt_state_from_jax(tree, device=None):
    """An optimizer state (rmsprop's ``{"sq": params-shaped}``, adam's
    ``{"m", "v", "t"}``, sgd's ``()``) from numpy leaves."""
    return _params_like(tree, device)


def delayed_grad_from_jax(state, device=None) -> delayed_grad.DelayedGradState:
    """A reference ``DelayedGradState`` (its four fields, numpy leaves) as
    the port's: params and the behavior history (plain or a (K, ...)
    ring) through ``policy_params_from_jax``, the optimizer state through
    ``opt_state_from_jax``, ``step`` as int32."""
    params, prev, opt_state, step = state
    return delayed_grad.DelayedGradState(
        params=policy_params_from_jax(params, device),
        params_prev=policy_params_from_jax(prev, device),
        opt_state=opt_state_from_jax(opt_state, device),
        step=to_torch(np.asarray(step, np.int32), device))


def env_state_from_jax(state: dict, device=None) -> dict:
    """A (stacked) env state dict, e.g. catch's int32 ``ball_r``,
    ``ball_c``, ``paddle``."""
    return {k: to_torch(v, device) for k, v in state.items()}


def _algo_from_jax(algo, device=None):
    """A capsule's ``algo``: the HTS family's ``DelayedGradState`` (a
    NamedTuple), or a baseline's plain tuple, ``(params, opt_state)``
    for sync and ``(params, opt_state, history)`` for async, the
    history a params-shaped (staleness, ...) ring."""
    if hasattr(algo, "_fields"):
        return delayed_grad_from_jax(algo, device)
    params, opt_state, *history = algo
    return (policy_params_from_jax(params, device),
            opt_state_from_jax(opt_state, device),
            *(policy_params_from_jax(h, device) for h in history))


def train_state_from_jax(state, device=None):
    """A reference ``TrainState`` capsule (numpy leaves) of the HTS
    family or of a baseline as the port's, which ``run_from`` continues:
    the leaves keep their ``jax.tree_util`` order (``tree_leaves``) and
    dtypes."""
    from repro_torch.core.engine import TrainState
    algo, env_state, obs, buffer, interval = state
    return TrainState(
        algo=_algo_from_jax(algo, device),
        env_state=env_state_from_jax(env_state, device),
        obs=to_torch(obs, device),
        buffer={k: to_torch(v, device) for k, v in buffer.items()},
        interval=to_torch(np.asarray(interval, np.int32)))


def to_numpy(t) -> np.ndarray:
    """A tensor (any device) as a host numpy array of the same dtype."""
    return t.detach().cpu().numpy()


def policy_params_to_reference(tree: dict) -> dict:
    """The inverse of ``policy_params_from_jax``: numpy leaves, conv
    kernels OIHW -> HWIO."""
    return {k: _oihw_to_hwio(to_numpy(v)) if _is_conv_kernel(k)
            else to_numpy(v) for k, v in tree.items()}


def train_state_to_reference(state):
    """A capsule (the port's ``TrainState``, of the HTS family or of a
    baseline) as numpy leaves in the reference's layout, with the same
    NamedTuple types, so ``checkpoint.io`` writes what the reference
    would: the inverse of ``train_state_from_jax``."""
    return _map_params_like(state, policy_params_to_reference, to_numpy)
