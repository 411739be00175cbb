"""Delayed gradient with a staleness bound K (paper Sec. 4.1, Eq. 6 at
K=1; appendix C):

    theta_{j+1} = theta_j + eta * grad_{theta_{j-K}} J(theta_{j-K}, D^{theta_{j-K}})

Counterpart of ``repro/core/delayed_grad.py``. ``DelayedGradState``
carries (params, params_prev, opt_state, step); ``params_prev`` is the
behavior history: the one-update-old params at K=1, a stacked ring with a
leading K axis (oldest first, theta_{j-K} .. theta_{j-1}) for K > 1. The
depth is read off the leaf shapes.

``update`` builds new tensors and writes none in place: the rollout half
of an interval reads ``params`` on another stream while the learner half
makes the next ones. ``update_`` is the same K=1 step in place, for the
``stream`` runtime, whose one learner owns its state.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim import Optimizer, apply_updates


class DelayedGradState(NamedTuple):
    params: Any         # theta_j  (target policy: receives updates)
    params_prev: Any    # behavior history (plain at K=1, (K, ...) ring else)
    opt_state: Any
    step: torch.Tensor  # int32: updates applied


def init(params, opt: Optimizer, staleness: int = 1) -> DelayedGradState:
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if staleness == 1:
        prev = tree_map(torch.clone, params)
    else:
        prev = tree_map(lambda p: torch.stack([p] * staleness), params)
    return DelayedGradState(
        params=params,
        params_prev=prev,
        opt_state=opt.init(params),
        step=torch.zeros((), dtype=torch.int32,
                         device=tree_leaves(params)[0].device),
    )


def behavior_lag(state: DelayedGradState) -> int:
    """The structural staleness bound K, read off the leaf shapes."""
    p = tree_leaves(state.params)[0]
    h = tree_leaves(state.params_prev)[0]
    return int(h.shape[0]) if h.dim() == p.dim() + 1 else 1


def behavior_params(state: DelayedGradState):
    """theta_{j-K}: the gradient point of the next update."""
    if behavior_lag(state) == 1:
        return state.params_prev
    return tree_map(lambda h: h[0], state.params_prev)


def _advance_history(state: DelayedGradState):
    """Drop theta_{j-K}, append theta_j. At K=1 the history IS theta_j."""
    if behavior_lag(state) == 1:
        return state.params
    return tree_map(lambda h, p: torch.cat([h[1:], p[None]], dim=0),
                    state.params_prev, state.params)


def update(state: DelayedGradState, grads, opt: Optimizer,
           skip: Optional[bool] = None) -> DelayedGradState:
    """Apply a gradient taken at ``behavior_params(state)`` to params.

    ``skip`` (a host bool, known per interval): keep the params and the
    optimizer state and do not count the update in ``step``; the behavior
    history still advances. Used for the first K intervals, whose ring
    slot nothing has filled yet. ``grads`` may be None when skipped."""
    if skip:
        return DelayedGradState(params=state.params,
                                params_prev=_advance_history(state),
                                opt_state=state.opt_state, step=state.step)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    return DelayedGradState(
        params=apply_updates(state.params, updates),
        params_prev=_advance_history(state),
        opt_state=opt_state,
        step=state.step + 1,
    )


def update_(state: DelayedGradState, grads,
            opt: Optimizer) -> DelayedGradState:
    """``update`` at K=1 in place, for a caller that donates ``state``
    (the ``stream`` runtime): the optimizer state is updated leaf by leaf
    in place (``opt.update_``), theta_{j+1} is written into the buffer of
    theta_{j-1} (``params_prev``), whose one reader, the gradient, is
    done, and the two buffers swap roles. The same bits as ``update``;
    ``state`` and its tensors are not to be used afterwards. An optimizer
    without ``update_`` takes ``update``."""
    if behavior_lag(state) != 1:
        raise ValueError("update_ is the K=1 update; the behavior ring of "
                         f"K={behavior_lag(state)} takes update")
    if opt.update_ is None:
        return update(state, grads, opt)
    out = state.params_prev
    opt_state = opt.update_(grads, state.opt_state, state.params, out)
    return DelayedGradState(params=out, params_prev=state.params,
                            opt_state=opt_state, step=state.step + 1)
