"""Data-parallel HTS-RL: the fused interval over the ranks of a
``torch.distributed`` process group.

Counterpart of ``repro/core/sharded_runtime.py``. The env replicas are
split in contiguous blocks over the ranks (rank r holds global envs
``r * n_local .. (r + 1) * n_local - 1``); every rank runs the mesh
runtime's interval (``mesh_runtime.make_hts_step``) over its block, with
the params replicated, and the ranks exchange one thing per logical
step: the canonical gradient SUM, all-gathered in rank order and
combined by the pairwise tree (``mesh_runtime.combine_across``).

Determinism across rank counts and processes: env ids are offset by
``rank * n_local``, so env e draws the (seed, e, step) keys it draws in
one process, and the gradient is the canonical tree sum divided once by
the global env count, so the params are the mesh runtime's bit for bit
for every validated geometry. On the card that also needs the actor and
the per-env gradients to run at the global width (``rollout_interval``'s
``width``, ``make_grad_sum_fn``'s padding), since cuBLAS and cuDNN give a
row other bits at another batch width: each rank computes the batch
rows of all envs and keeps its own.

The capsule is the GLOBAL one: ``state()`` all-gathers the env rows of
every rank (env state and obs on dim 0, the ring on its env axis, which
comes after the staleness axis at K > 1; ``dg`` and ``j`` are
replicated), and ``run_from`` keeps this rank's rows of a global
capsule, so a ``mesh`` capsule continues on ``sharded`` at any replica
count and the other way round. The metric streams are all-gathered back
to every rank.

With no process group (``torch.distributed`` not initialized and no
``group`` given) the runtime is the 1-replica case: the mesh runtime's
interval over all envs.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import distributed, mesh_runtime
from repro_torch.core.batch import BatchConfig
from repro_torch.core.engine import (HTSConfig, ScanRuntimeBase,
                                     TrainState, register_runtime)
from repro_torch.core.tree import tree_map
from repro_torch.envs.device import batched_env
from repro_torch.optim import Optimizer


def _env_dims(staleness: int) -> dict:
    """The env axis of each capsule field: env state and obs lead with
    it; a trajectory leaf is (alpha, n_envs, ...) and ``bootstrap_obs``
    (n_envs, ...), each behind the ring's K axis at K > 1."""
    ring = 1 if staleness > 1 else 0
    return {"state": 0, "traj": 1 + ring, "bootstrap_obs": ring}


@register_runtime("sharded")
class ShardedHTSRL(ScanRuntimeBase):
    name = "sharded"

    def __init__(self, env, policy_apply: Callable, params,
                 opt: Optimizer, cfg: HTSConfig, group=None,
                 batch=None, device=None):
        super().__init__(env, policy_apply, params, opt, cfg, device)
        if cfg.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {cfg.staleness}")
        self.batch = BatchConfig.of(batch)
        if group is None and distributed.is_initialized():
            group = distributed.global_data_group()
        if group is None:
            world = 1
            if self.batch.n_replicas not in (None, 1):
                raise ValueError(
                    f"batch.n_replicas={self.batch.n_replicas} but only 1 "
                    f"process is running; start one process per replica "
                    f"(repro_torch.launch.distributed) or pass a process "
                    f"group")
        else:
            world = distributed.rank_and_size(group)[1]
            if (self.batch.n_replicas is not None
                    and self.batch.n_replicas != world):
                raise ValueError(
                    f"batch.n_replicas={self.batch.n_replicas} != the "
                    f"{world}-rank process group provided; size the group "
                    f"from the batch geometry")
        self.group = group
        self.geometry = self.batch.resolve(cfg.n_envs,
                                           default_replicas=world)
        if cfg.n_envs % world:
            raise ValueError(
                f"n_envs={cfg.n_envs} not divisible by the {world}-rank "
                f"process group")
        self.n_shards = world
        self.rank = 0 if group is None else distributed.rank_and_size(group)[0]
        self.lcfg = cfg._replace(n_envs=cfg.n_envs // world)
        self.venv_local = batched_env(env, self.lcfg.n_envs, cfg.env_backend)
        self.venv_global = batched_env(env, cfg.n_envs, cfg.env_backend)
        self._dims = _env_dims(cfg.staleness)

    # ------------------------------------------------------------ build
    def _build(self) -> None:
        # canonical tree SUMS per rank, combined across the group once per
        # logical step, divided by the GLOBAL env count at the end
        A = self.geometry.grad_accumulation
        self._step = mesh_runtime.make_hts_step(
            self.policy_apply, self.venv_local, self.opt, self.lcfg,
            grad_accumulation=A, device=self.device, group=self.group,
            total_envs=self.cfg.n_envs)
        learn = mesh_runtime.make_learner_update(
            self.policy_apply, self.opt, self.lcfg, group=self.group,
            grad_accumulation=A, total_envs=self.cfg.n_envs)
        self._final_fn = mesh_runtime.make_ring_drain(learn,
                                                      self.cfg.staleness)

    def _initial_carry(self):
        # every rank computes the whole global initial carry from the seed
        # (cheap at init) and keeps its own rows: no transfer at all
        carry = mesh_runtime.init_carry(self.params0, self.opt,
                                        self.venv_global, self.cfg,
                                        self.device)
        return self._state_to_carry(TrainState(*carry))

    # ------------------------------------------------ rows of the capsule
    def _map_rows(self, state: TrainState, fn) -> TrainState:
        """``fn(x, dim)`` over every env-sharded leaf of a capsule."""
        d = self._dims
        buf = {k: fn(v, d["bootstrap_obs"] if k == "bootstrap_obs"
                     else d["traj"]) for k, v in state.buffer.items()}
        return state._replace(
            env_state=tree_map(lambda x: fn(x, d["state"]), state.env_state),
            obs=fn(state.obs, d["state"]), buffer=buf)

    def _carry_to_state(self, carry) -> TrainState:
        """The global capsule: every rank's env rows, gathered."""
        state = TrainState(*carry)
        if self.group is None:
            return state
        return self._map_rows(
            state, lambda x, dim: distributed.all_gather_cat(x, dim,
                                                             self.group))

    def _state_to_carry(self, state: TrainState):
        """This rank's rows of a global capsule."""
        if self.group is None:
            return tuple(state)
        n = self.lcfg.n_envs
        lo = self.rank * n
        return tuple(self._map_rows(
            state, lambda x, dim: x.narrow(dim, lo, n).clone()))

    def _host_metrics(self, rewards, dones):
        # (n, alpha, n_local) per rank -> the global streams on every rank
        if self.group is None:
            return rewards, dones
        return (distributed.all_gather_cat(rewards, 2, self.group),
                distributed.all_gather_cat(dones, 2, self.group))

    def _finalize(self, carry):
        dg, env_state, obs, buf, j = carry
        return (self._final_fn(dg, buf, int(j)), env_state, obs, buf, j)

    def _result_state(self, carry):
        return carry[0].params, carry[0]
