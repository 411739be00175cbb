"""Optimizers and the optimizer registry: ``get_optimizer(name,
**kwargs)``. Counterpart of ``repro/optim/__init__.py``.

    from repro_torch import optim
    opt = optim.get_optimizer("rmsprop", lr=7e-4, eps=1e-5)
    opt = optim.get_optimizer("adam", lr=3e-4, clip_norm=1.0)

``clip_norm`` is accepted by every entry: it chains a global-norm clip
in front of the optimizer (``clip_by_global_norm``).
"""
from typing import Callable, Dict

from repro_torch.optim.optimizers import (  # noqa: F401
    adam, rmsprop, sgd, clip_by_global_norm, chain, apply_updates,
    Optimizer)
from repro_torch.optim import schedules  # noqa: F401

_REGISTRY: Dict[str, Callable[..., Optimizer]] = {}


def register_optimizer(name: str):
    """Factory decorator over a ``(**kwargs) -> Optimizer`` callable."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_optimizer(name: str, clip_norm: float = 0.0, **kwargs) -> Optimizer:
    """Build a registered optimizer: ``get_optimizer("rmsprop",
    lr=7e-4, eps=1e-5)``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown optimizer {name!r}; "
                       f"registered: {optimizer_names()}") from None
    opt = factory(**kwargs)
    if clip_norm:
        opt = chain(clip_by_global_norm(clip_norm), opt)
    return opt


def optimizer_names():
    return sorted(_REGISTRY)


register_optimizer("sgd")(sgd)
register_optimizer("rmsprop")(rmsprop)
register_optimizer("adam")(adam)
