"""Policy registry: resolve an (init, apply) policy pair by name, sized to
an environment.

Counterpart of ``repro/models/__init__.py``. A ``Policy`` bundles
``init(key) -> params`` (``key`` a threefry key, ``core.determinism``;
params are made on the key's device), ``apply(params, obs) -> (logits,
value)`` and ``config``. Built-ins:

  mlp       obs-flattening 2-layer tanh MLP: obs of any rank become
            (B, obs_dim)
  cnn       the paper's conv trunk (configs.paper_cnn); kwargs override
            CNNPolicyConfig fields
  token     embedding policy over an integer-token observation
  backbone  a decoder LLM (configs.base.get_config) as the policy/value
            network; kwargs: arch, reduced, plus ModelConfig field
            overrides (n_layers, dtype, ...). Its params are a flat
            {name: tensor} dict (``Backbone.named_parameters``), drawn on
            the key's device; ``apply`` is None: the ``stream`` runtime's
            learner (``core/learner.py``) consumes it through ``config``

The built-ins load on first lookup: the serving modules import from this
package, and ``cnn_policy`` is not theirs to load.

    from repro_torch import envs, models
    from repro_torch.core import determinism
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    params = pol.init(determinism.master_key(0))
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional


class Policy(NamedTuple):
    name: str
    init: Callable             # key -> params
    apply: Optional[Callable]  # (params, obs) -> (logits (B,A), value (B,))
    config: Any = None


_REGISTRY: Dict[str, Callable[..., Policy]] = {}


def register_policy(name: str):
    """Factory decorator over a ``(env, **kwargs) -> Policy`` callable."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_policy(name: str, env, **kwargs) -> Policy:
    """Build a registered policy sized to ``env``."""
    _load_builtins()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; "
                       f"registered: {policy_names()}") from None
    return factory(env, **kwargs)


def policy_names():
    _load_builtins()
    return sorted(_REGISTRY)


_BUILTINS_LOADED = False


def _load_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True

    import math

    @register_policy("mlp")
    def _mlp(env, hidden: int = 128) -> Policy:
        from repro_torch.models.cnn_policy import (apply_mlp_policy,
                                                   init_mlp_policy)
        obs_dim = math.prod(env.obs_shape)

        def apply(params, obs):
            return apply_mlp_policy(params, obs.reshape(obs.shape[0], -1))

        return Policy(
            "mlp",
            lambda key: init_mlp_policy(key, obs_dim, env.n_actions,
                                        hidden),
            apply)

    @register_policy("cnn")
    def _cnn(env, **overrides) -> Policy:
        import dataclasses

        from repro_torch.configs.paper_cnn import CNNPolicyConfig
        from repro_torch.models.cnn_policy import apply_cnn, init_cnn
        # JSON round-trips deliver tuple fields as lists
        overrides = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in overrides.items()}
        ccfg = dataclasses.replace(
            CNNPolicyConfig(obs_shape=env.obs_shape,
                            n_actions=env.n_actions), **overrides)
        return Policy(
            "cnn",
            lambda key: init_cnn(key, ccfg, env.n_actions, env.obs_shape),
            lambda params, obs: apply_cnn(params, obs, ccfg),
            config=ccfg)

    @register_policy("token")
    def _token(env, hidden: int = 128) -> Policy:
        from repro_torch.models.cnn_policy import (apply_token_policy,
                                                   init_token_policy)
        return Policy(
            "token",
            lambda key: init_token_policy(key, env.n_actions, hidden),
            apply_token_policy)

    @register_policy("backbone")
    def _backbone(env, arch: str = "starcoder2-3b", reduced: bool = False,
                  **overrides) -> Policy:
        import dataclasses

        import torch

        from repro_torch.configs.base import get_config
        from repro_torch.models import backbone
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        if overrides:
            # JSON round-trips deliver tuple fields (the cycles) as lists
            cfg = dataclasses.replace(cfg, **{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in overrides.items()})

        def init(key):
            # the key's two uint32 words seed a generator on its device:
            # a pure function of the key, not the reference's numbers
            # (tests bridge JAX weights across)
            words = [int(w) for w in key.cpu()]
            gen = torch.Generator(device=key.device).manual_seed(
                (words[0] << 32) | words[1])
            model = backbone.init_params(cfg, gen, key.device)
            return {n: p.detach() for n, p in model.named_parameters()}

        return Policy("backbone", init, None, config=cfg)
