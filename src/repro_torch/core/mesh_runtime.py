"""HTS-RL's fused interval: the learner half and the rollout half of one
synchronization interval, on two CUDA streams.

Counterpart of ``repro/core/mesh_runtime.py``. Per interval j:

  * learner:  g = grad J(theta_{j-K}, D^{theta_{j-K}}) from the oldest
              ring slot, applied to theta_j (delay-K gradient, Eq. 6 at
              the default K=1);
  * rollout:  D^{theta_j} collected with the pre-update params.

The halves share no dataflow, so on CUDA each runs on its own stream and
both join the current stream before the next interval; on the CPU they
run one after the other. The ring is positional in the carry: at K=1 the
fresh trajectory replaces the read slot, at K>1 the oldest of K stacked
slots is consumed and the fresh trajectory appended.

Stream safety: an interval reads the carry the previous one made, and
every tensor it reads stays referenced until both streams have joined
the current stream; the next interval's streams wait on the current
stream before they allocate. So no block of the caching allocator is
handed out again while another stream may still read it, and nothing
here writes a tensor in place (``delayed_grad.update`` and the
optimizers build new ones), so the rollout's theta_j is never raced by
the learner's theta_{j+1}.

The update math lives in ``repro_torch.algorithms`` (``cfg.algorithm``);
this module is scheduling.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch import algorithms, resolve_device
from repro_torch.core import delayed_grad, determinism, distributed
from repro_torch.core.batch import BatchConfig, pairwise_tree_sum
from repro_torch.core.buffers import device_rollout_buffer
from repro_torch.core.engine import (HTSConfig, RunResult,  # noqa: F401
                                     ScanRuntimeBase, register_runtime,
                                     scan_intervals)
from repro_torch.core.rollout import RolloutConfig, rollout_interval
from repro_torch.core.tree import tree_map
from repro_torch.envs.device import batched_env
from repro_torch.optim import Optimizer


def _interval_loss(policy_apply, params, traj, cfg: HTSConfig):
    """Loss over one interval's trajectory (alpha, n_envs, ...), resolved
    through the algorithm registry (the baselines differentiate it over
    the whole batch at once)."""
    return algorithms.get_algorithm(cfg.algorithm).loss(
        policy_apply, params, traj, cfg)


def _split_envs(traj):
    """Env axis first: regular leaves (alpha, N, ...) -> (N, alpha, 1, ...),
    bootstrap_obs (N, ...) -> (N, 1, ...). Row e is the width-1
    trajectory env e alone would have produced."""
    return {k: v[:, None] if k == "bootstrap_obs" else v.movedim(1, 0)[:, :, None]
            for k, v in traj.items()}


def make_grad_sum_fn(policy_apply: Callable, cfg: HTSConfig,
                     grad_accumulation: int = 1, group=None):
    """``grad_sum(params, traj)``: the SUM of per-env gradients.

    One ``vmap`` of ``grad`` over width-1 env slices at the full local
    width; per-env grads cast to fp32 and combined by the pairwise tree
    over the env index. With ``grad_accumulation = A > 1`` each of A
    contiguous blocks is summed by its own tree, then the tree runs over
    the A block sums: bit-identical to the flat tree for power-of-two
    blocks. No divide here: that happens once, in make_grad_fn /
    make_learner_update.

    With a process ``group`` the vmap runs at the GLOBAL width: this
    rank's envs sit at their global rows of a zero-padded trajectory and
    only their gradients are kept. cuBLAS and cuDNN pick kernels by
    shape, so a per-env gradient's bits depend on the width of the vmap
    that computes it (on the H100 a width of 2 or 4 differs from 16),
    never on its row or on the other rows; at the global width each env
    gets the 1-process run's bits."""
    alg = algorithms.get_algorithm(cfg.algorithm)
    per_env_grad = torch.func.vmap(
        torch.func.grad(lambda p, t: alg.loss(policy_apply, p, t, cfg)[0]),
        in_dims=(None, 0))
    A = grad_accumulation

    def block_sums(g):
        n = g.shape[0]
        if n % A:
            raise ValueError(
                f"grad_accumulation={A} does not divide the local env "
                f"count {n}")
        blocks = g.reshape((A, n // A) + g.shape[1:])
        return torch.stack([pairwise_tree_sum(b) for b in blocks])

    def per_env_grads(params, traj):
        if group is None:
            return per_env_grad(params, _split_envs(traj))
        # padded in the trajectory's own (alpha, n_envs, ...) layout, so
        # the vmap reads the strides the 1-process run's does (the CPU's
        # convolutions take another path for other strides)
        rank, size = distributed.rank_and_size(group)
        n = cfg.n_envs
        rows = slice(rank * n, (rank + 1) * n)
        padded = {k: _pad_rows(v, rows, n * size, 0 if k == "bootstrap_obs"
                               else 1) for k, v in traj.items()}
        return tree_map(lambda g: g[rows],
                        per_env_grad(params, _split_envs(padded)))

    def grad_sum(params, traj):
        per_env = tree_map(lambda g: g.float(), per_env_grads(params, traj))
        if A <= 1:
            return tree_map(pairwise_tree_sum, per_env)
        return tree_map(lambda g: pairwise_tree_sum(block_sums(g)), per_env)

    return grad_sum


def _pad_rows(x, rows: slice, width: int, dim: int = 0):
    """``x`` at ``rows`` of dim ``dim`` of a zero tensor ``width`` wide
    there; ``x`` itself when it already spans the width."""
    if x.shape[dim] == width:
        return x
    shape = list(x.shape)
    shape[dim] = width
    out = x.new_zeros(shape)
    out.narrow(dim, rows.start, rows.stop - rows.start).copy_(x)
    return out


def make_grad_fn(policy_apply: Callable, cfg: HTSConfig,
                 grad_accumulation: int = 1,
                 total_envs: Optional[int] = None):
    """``grad(params, traj)``: the per-env tree sum divided once by
    ``total_envs`` (default ``cfg.n_envs``): the gradient of the mean
    interval loss."""
    grad_sum = make_grad_sum_fn(policy_apply, cfg, grad_accumulation)
    denom = float(total_envs if total_envs is not None else cfg.n_envs)

    def grad_fn(params, traj):
        return tree_map(lambda g, p: (g / denom).to(p.dtype),
                        grad_sum(params, traj), params)

    return grad_fn


def combine_across(sums, group):
    """The cross-replica combine: every rank's canonical gradient SUM,
    all-gathered in rank (= env block) order as one flat buffer, one
    collective per logical step, then the pairwise tree over the rank
    axis. Not ``all_reduce``, whose order the backend defines; and not a
    sum of zero-padded slots, since ``-0.0 + 0.0`` is ``+0.0``."""
    keys = sorted(sums)
    flat = torch.cat([sums[k].reshape(-1) for k in keys])
    gathered = distributed.all_gather_stack(flat, group)
    out, at = {}, 0
    for k in keys:
        n = sums[k].numel()
        out[k] = pairwise_tree_sum(
            gathered[:, at:at + n].reshape((-1,) + tuple(sums[k].shape)))
        at += n
    return {k: out[k] for k in sums}


def make_learner_update(policy_apply: Callable, opt: Optimizer,
                        cfg: HTSConfig, group=None,
                        grad_accumulation: int = 1,
                        total_envs: Optional[int] = None):
    """The learner half: ``learn(dg, traj, skip) -> dg'``.

    Differentiates at ``behavior_params(dg)`` (theta_{j-K}) on ``traj``
    and applies one delay-K update. ``skip`` (a host bool) keeps params
    and optimizer state, as for the first K intervals; no gradient is
    computed then. The divided gradient is materialized before the
    optimizer reads it: eager PyTorch fuses nothing across that rounding
    boundary, where the reference needs ``optimization_barrier``.

    Data-parallel (``group``, the counterpart of the reference's
    ``axis_name``): each rank contributes its canonical tree SUM over its
    ``cfg.n_envs`` local envs, the sums are combined across ranks by
    ``combine_across``, and the single divide by the global env count
    (``total_envs``, default ``cfg.n_envs``) comes after that combine:
    bit-identical to the 1-process run for every geometry whose blocks
    align with the canonical tree."""
    grad_sum = make_grad_sum_fn(policy_apply, cfg, grad_accumulation, group)
    denom = float(total_envs if total_envs is not None else cfg.n_envs)

    def learn(dg, traj, skip: bool = False):
        if skip:
            return delayed_grad.update(dg, None, opt, skip=True)
        bp = delayed_grad.behavior_params(dg)
        s = grad_sum(bp, traj)
        if group is not None:
            s = combine_across(s, group)
        grads = tree_map(lambda g, p: (g / denom).to(p.dtype), s, bp)
        return delayed_grad.update(dg, grads, opt)

    return learn


def ring_read(buf, staleness: int):
    """The slot the next learner pass consumes: the single pending
    trajectory at K=1, the oldest stacked slot otherwise."""
    return buf if staleness == 1 else tree_map(lambda x: x[0], buf)


def ring_append(buf, traj, staleness: int):
    """Drop the consumed oldest slot, append the fresh trajectory. At K=1
    the ring IS the trajectory."""
    if staleness == 1:
        return traj
    return tree_map(lambda r, t: torch.cat([r[1:], t[None]], dim=0), buf,
                    traj)


def make_ring_drain(learn, staleness: int):
    """The reporting-only trailing passes: consume the K pending slots in
    interval order so ``run(n)`` reflects exactly ``n`` updates. Pass p
    consumes the data of global interval ``j - K + p``; ``skip`` guards
    slots that no interval has filled (n < K). One learner pass per call,
    K calls, as the reference dispatches one program per pass; under the
    sharded runtime ``learn`` carries the process group, so each pass
    makes its own one collective."""

    def drain(dg, buf, j: int):
        for p in range(staleness):
            traj = buf if staleness == 1 else tree_map(lambda x: x[p], buf)
            dg = learn(dg, traj, skip=j - staleness + p < 0)
        return dg

    return drain


class _Streams:
    """The learner half and the rollout half on a CUDA stream each;
    ``fork`` orders both after the current stream's work, ``join`` orders
    the current stream after both. On the CPU all three are no-ops."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.device = device
            self.learner_stream = torch.cuda.Stream(device)
            self.rollout_stream = torch.cuda.Stream(device)

    def fork(self) -> None:
        if self.cuda:
            main = torch.cuda.current_stream(self.device)
            self.learner_stream.wait_stream(main)
            self.rollout_stream.wait_stream(main)

    def learner(self):
        return (torch.cuda.stream(self.learner_stream) if self.cuda
                else contextlib.nullcontext())

    def rollout(self):
        return (torch.cuda.stream(self.rollout_stream) if self.cuda
                else contextlib.nullcontext())

    def join(self) -> None:
        if self.cuda:
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(self.learner_stream)
            main.wait_stream(self.rollout_stream)


def make_hts_step(policy_apply: Callable, env, opt: Optimizer,
                  cfg: HTSConfig, grad_accumulation: int = 1, device=None,
                  group=None, total_envs: Optional[int] = None):
    """The fused interval: ``step(carry) -> (carry', metrics)`` with
    carry ``(dg, env_state, obs, ring, j)``. The two halves are labelled
    ``hts.learner`` and ``hts.rollout`` for the profiler.

    With a process ``group`` (the sharded runtime) ``cfg.n_envs`` is the
    per-rank env count: env ids are offset by ``rank * cfg.n_envs``, so
    each env draws the keys it draws in the 1-process run, the actor
    runs at the global width (``rollout_interval``'s ``width``), and the
    learner combines the ranks' gradient sums before dividing by
    ``total_envs``. ``device=None`` means ``cuda`` (``resolve_device``):
    without CUDA only an explicit ``"cpu"`` runs."""
    device = resolve_device(device)
    rcfg = RolloutConfig(cfg.alpha, cfg.n_envs)
    master = determinism.master_key(cfg.seed, device)
    learn = make_learner_update(policy_apply, opt, cfg, group,
                                grad_accumulation, total_envs)
    offset, width = 0, None
    if group is not None:
        rank, size = distributed.rank_and_size(group)
        offset, width = rank * cfg.n_envs, size * cfg.n_envs
    K = cfg.staleness
    streams = _Streams(device)
    record = torch.profiler.record_function

    def step(carry):
        dg, env_state, obs, ring, j = carry
        jj = int(j)
        streams.fork()
        with streams.learner(), record("hts.learner"):
            dg_next = learn(dg, ring_read(ring, K), skip=jj < K)
        with streams.rollout(), record("hts.rollout"):
            traj, env_state, obs = rollout_interval(
                policy_apply, env, dg.params, env_state, obs, master,
                jj * cfg.alpha, rcfg, env_offset=offset, width=width)
        streams.join()
        metrics = {"rewards": traj["rewards"], "dones": traj["dones"]}
        return (dg_next, env_state, obs, ring_append(ring, traj, K),
                j + 1), metrics

    return step


def init_carry(policy_params, opt: Optimizer, env, cfg: HTSConfig,
               device=None):
    """Initial (dg_state, env_state, obs, zero ring, j = 0): env replicas
    reset from ``split(key(seed ^ 0x5EED), n_envs)``. ``policy_params``
    are copied to ``device`` (``None`` means ``cuda``); ``j`` is an int32
    tensor on the CPU (``TrainState``)."""
    device = resolve_device(device)
    keys = determinism.split(
        determinism.master_key(cfg.seed ^ 0x5EED, device), cfg.n_envs)
    env_state, obs = env.reset(keys)
    dg = delayed_grad.init(
        tree_map(lambda p: p.to(device, copy=True), policy_params), opt,
        staleness=cfg.staleness)
    zero_traj = device_rollout_buffer(cfg.n_envs, cfg.alpha, obs.shape[1:],
                                      obs.dtype, device=device)
    if cfg.staleness > 1:
        zero_traj = tree_map(lambda x: torch.stack([x] * cfg.staleness),
                             zero_traj)
    return (dg, env_state, obs, zero_traj,
            torch.zeros((), dtype=torch.int32))


def train(policy_params, policy_apply: Callable, env, opt: Optimizer,
          cfg: HTSConfig, n_intervals: int, unroll: int = 1, device=None):
    """Run ``n_intervals`` HTS-RL intervals on an already vectorized
    ``env`` (``vectorize(env1, cfg.n_envs)``). Returns (final carry,
    metrics): the carry is ``init_carry``'s after ``n_intervals`` steps,
    metrics ``{"rewards", "dones"}`` stacked to (n_intervals, alpha,
    n_envs) on the run's device.

    The final interval's trajectory is left unconsumed in the carry (its
    update would belong to interval n): ``train(n + 1)``'s params are
    ``MeshRuntime.run(n)``'s, whose trailing learner pass lines the update
    counts up across runtimes. ``unroll`` (>= 1) is the reference's scan
    unroll and does not change the result. ``device=None`` means
    ``cuda``; without CUDA only an explicit ``"cpu"`` runs."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    device = resolve_device(device)
    step = make_hts_step(policy_apply, env, opt, cfg, device=device)
    carry = init_carry(policy_params, opt, env, cfg, device)
    return scan_intervals(step, carry, n_intervals, cfg, device)


@register_runtime("mesh")
class MeshRuntime(ScanRuntimeBase):
    """The fused runtime: one interval = the learner half and the rollout
    half on two streams.

    ``batch`` (a ``BatchConfig`` or its dict) is factorization
    bookkeeping: the gradient is reduced over ``grad_accumulation *
    n_replicas`` blocks, which gives the same bits as the default for any
    geometry the validation accepts."""

    name = "mesh"

    def __init__(self, env, policy_apply: Callable, params,
                 opt: Optimizer, cfg: HTSConfig, batch=None, device=None):
        super().__init__(env, policy_apply, params, opt, cfg, device)
        if cfg.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {cfg.staleness}")
        self.batch = BatchConfig.of(batch)
        self.geometry = self.batch.resolve(cfg.n_envs, default_replicas=1)
        # env_backend resolves here, at construction
        self.venv = batched_env(env, cfg.n_envs, cfg.env_backend)

    def _build(self) -> None:
        chunks = self.geometry.chunks
        self._step = make_hts_step(self.policy_apply, self.venv, self.opt,
                                   self.cfg, grad_accumulation=chunks,
                                   device=self.device)
        learn = make_learner_update(self.policy_apply, self.opt, self.cfg,
                                    grad_accumulation=chunks)
        self._final_fn = make_ring_drain(learn, self.cfg.staleness)
        self.grad_fn = make_grad_fn(self.policy_apply, self.cfg,
                                    grad_accumulation=chunks)

    def _initial_carry(self):
        return init_carry(self.params0, self.opt, self.venv, self.cfg,
                          self.device)

    def _finalize(self, carry):
        dg, env_state, obs, buf, j = carry
        return (self._final_fn(dg, buf, int(j)), env_state, obs, buf, j)

    def _result_state(self, carry):
        return carry[0].params, carry[0]


def episode_returns(metrics) -> torch.Tensor:
    """Completed-episode returns from stacked (intervals, alpha, n_envs)
    reward/done streams: (steps, n_envs), NaN where no episode ended."""
    r = torch.as_tensor(metrics["rewards"])
    r = r.reshape(-1, r.shape[-1])
    d = torch.as_tensor(metrics["dones"]).reshape(r.shape)
    acc = torch.zeros(r.shape[-1], dtype=r.dtype, device=r.device)
    outs = []
    for rr, dd in zip(r, d):
        acc = acc + rr
        outs.append(torch.where(dd > 0, acc, torch.nan))
        acc = torch.where(dd > 0, 0.0, acc)
    return torch.stack(outs)
