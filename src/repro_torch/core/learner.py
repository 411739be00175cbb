"""The HTS-RL learner at LLM scale: A2C/PPO updates over token
trajectories with a decoder backbone as the policy/value network.

Counterpart of ``repro/core/learner.py``. ``make_train_step`` is the
learner half of the interval: the gradient is taken at
``dg.params_prev`` (the behavior policy, one update old) and applied to
``dg.params`` (``core/delayed_grad.py``). ``make_prefill_step`` and
``make_serve_step`` are the actor side.

The params are a flat ``{name: tensor}`` dict (``Backbone``'s
``named_parameters``); the model runs on them through
``torch.func.functional_call`` on a weightless (meta) ``Backbone``, and
one ``torch.autograd.grad`` per step differentiates the loss. For
training every layer is checkpointed (``backbone.forward(remat=True)``)
and so is each sequence chunk of the loss (``_chunked_rl_loss``), as the
reference wraps its block and chunk bodies in ``jax.checkpoint``: the
(B, S, V) logits are never materialized whole.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import delayed_grad, losses
from repro_torch.models import backbone, layers
from repro_torch.optim import Optimizer


@functools.lru_cache(maxsize=8)
def _skeleton(cfg: ModelConfig) -> backbone.Backbone:
    """The weightless module ``functional_call`` runs params through."""
    return backbone.Backbone(cfg, device="meta")


def policy_hidden(params: dict, cfg: ModelConfig, batch, remat: bool = True):
    """(hidden (B, S, D), aux): aux is 0, the dense decoder has no
    auxiliary loss."""
    hidden = torch.func.functional_call(
        _skeleton(cfg), params, (cfg, batch["tokens"]),
        {"positions": batch.get("positions"), "remat": remat})
    return hidden, torch.zeros((), device=hidden.device)


def _heads(h, lm_head, value_head, cfg: ModelConfig):
    """(logits fp32, values fp32) of hidden states ``h``, as
    ``backbone.logits_and_value``."""
    logits = layers.softcap((h @ lm_head).float(), cfg.final_softcap)
    values = (h.float() @ value_head)[..., 0]
    return logits, values


def policy_outputs(params: dict, cfg: ModelConfig, batch,
                   remat: bool = True):
    """(logits (B, S, V) fp32, values (B, S) fp32, aux). Materializes the
    full logits; the training loss is the chunked one below."""
    hidden, aux = policy_hidden(params, cfg, batch, remat)
    logits, values = _heads(hidden, params["lm_head"], params["value_head"],
                            cfg)
    return logits, values, aux


def _chunk_sums(cfg: ModelConfig, algorithm: str, ppo_clip: float,
                h, act, adv, ret, blp, m, lm_head, value_head):
    """One sequence chunk's (pg, value, entropy, count) sums."""
    logits, values = _heads(h, lm_head, value_head, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, act.long()[..., None])[..., 0]
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
    adv = adv.float().detach()
    if algorithm == "ppo":
        ratio = torch.exp(lp - blp.float())
        un = ratio * adv
        cl = torch.clamp(ratio, 1 - ppo_clip, 1 + ppo_clip) * adv
        pg = -(torch.minimum(un, cl) * m)
    else:
        pg = -(lp * adv * m)
    vl = torch.square(values - ret.float()) * m
    return pg.sum(), vl.sum(), (ent * m).sum(), m.sum()


def _chunked_rl_loss(params: dict, cfg: ModelConfig, hidden, batch,
                     algorithm: str, value_coef: float, entropy_coef: float,
                     ppo_clip: float, chunk: int) -> losses.LossStats:
    """The loss over sequence chunks of the largest divisor of S up to
    ``chunk``, each under ``torch.utils.checkpoint``: a chunk's (B, c, V)
    logits live only while that chunk runs, forward and backward."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:          # the largest divisor <= the requested chunk
        chunk -= 1
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(batch["advantages"])
    body = functools.partial(_chunk_sums, cfg, algorithm, ppo_clip)
    sums = [torch.zeros((), device=hidden.device) for _ in range(4)]
    for c0 in range(0, S, chunk):
        c = slice(c0, c0 + chunk)
        out = torch.utils.checkpoint.checkpoint(
            body, hidden[:, c], batch["actions"][:, c],
            batch["advantages"][:, c], batch["returns"][:, c],
            batch["behavior_logprob"][:, c], mask[:, c],
            params["lm_head"], params["value_head"], use_reentrant=False)
        sums = [a + b for a, b in zip(sums, out)]
    pg, vl, ent, cnt = sums
    denom = torch.clamp(cnt, min=1.0)
    pg, vl, ent = pg / denom, vl / denom, ent / denom
    total = pg + value_coef * vl - entropy_coef * ent
    return losses.LossStats(total, pg, vl, ent)


def rl_loss(params: dict, cfg: ModelConfig, batch, algorithm: str = "a2c",
            value_coef: float = 0.5, entropy_coef: float = 0.01,
            ppo_clip: float = 0.2, loss_chunk: int = 512):
    """(total + aux, LossStats) over a (B, S) token batch."""
    hidden, aux = policy_hidden(params, cfg, batch)
    st = _chunked_rl_loss(params, cfg, hidden, batch, algorithm,
                          value_coef, entropy_coef, ppo_clip, loss_chunk)
    return st.total + aux, st


def _microbatches(batch: dict, n: int) -> list:
    """The batch split on its leading axis into ``n`` slices; a leaf
    whose leading axis ``n`` does not divide is repeated in each."""
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        B = v.shape[0] if v.dim() else 1
        parts = (v.chunk(n) if v.dim() >= 1 and B % n == 0
                 else [v] * n)
        for o, part in zip(out, parts):
            o[k] = part
    return out


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    algorithm: str = "a2c", n_microbatches: int = 1,
                    batch_geometry=None) -> Callable:
    """(dg_state, batch) -> (dg_state', stats). The step donates
    ``dg_state``: the update is made in place (``delayed_grad.update_``,
    the same bits as the functional update), as the reference's jitted
    step donates its state.

    ``n_microbatches`` > 1 accumulates gradients over slices of the
    batch's leading axis (summed in fp32, divided once; one optimizer
    step). ``batch_geometry`` (a ``core.batch.BatchConfig`` or its dict)
    says the same through ``grad_accumulation``; this learner is
    single-replica, so ``n_replicas`` must be unset or 1."""
    if batch_geometry is not None:
        from repro_torch.core.batch import BatchConfig
        bc = BatchConfig.of(batch_geometry)
        if bc.n_replicas not in (None, 1):
            raise ValueError(
                f"batch.n_replicas={bc.n_replicas}: train_step is "
                f"single-replica; use the sharded runtime for replica "
                f"scale-out")
        if n_microbatches != 1 and n_microbatches != bc.grad_accumulation:
            raise ValueError(
                f"n_microbatches={n_microbatches} conflicts with "
                f"batch.grad_accumulation={bc.grad_accumulation}; pass "
                f"one or the other")
        n_microbatches = bc.grad_accumulation

    def grad_one(params: dict, batch: dict):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        with torch.enable_grad():
            loss, st = rl_loss(leaves, cfg, batch, algorithm)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return (dict(zip(leaves, grads)),
                losses.LossStats(*(x.detach() for x in st)))

    def train_step(dg: delayed_grad.DelayedGradState, batch: dict):
        if n_microbatches <= 1:
            grads, st = grad_one(dg.params_prev, batch)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in dg.params_prev.items()}
            st = [torch.zeros((), device=grads["lm_head"].device)] * 4
            for mb in _microbatches(batch, n_microbatches):
                g, s = grad_one(dg.params_prev, mb)
                grads = {n: grads[n] + g[n] for n in grads}
                st = [a + b for a, b in zip(st, s)]
                del g
            grads = {n: g / n_microbatches for n, g in grads.items()}
            st = losses.LossStats(*(x / n_microbatches for x in st))
        new_dg = delayed_grad.update_(dg, grads, opt)
        stats = {"loss": st.total, "pg": st.pg, "value": st.value,
                 "entropy": st.entropy}
        return new_dg, stats

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """(params, batch) -> (logits_last (B, V), value_last (B,), cache),
    ``params`` the learner's flat dict."""

    def prefill_step(params: dict, batch):
        return backbone.prefill(backbone.from_params(cfg, params), cfg,
                                batch["tokens"], max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode; the actor's hot path."""

    def serve_step(model, token, cache, pos):
        return backbone.decode_step(model, cfg, token, cache, pos)

    return serve_step
