"""The data storages (paper Fig. 1(e)): the trajectory storage generalized
from the paper's double buffer to a staleness-K slab ring.

Counterpart of ``repro/core/buffers.py``. Two views:

* ``SlabRing`` — ``n_slots`` preallocated host slabs with the ring
  discipline of the threaded host runtime: slot roles rotate with the
  interval index, executors write numpy views of them, and
  ``as_traj(j, device)`` hands interval ``j``'s slab to the learner. The
  barrier that bounds staleness to K = n_slots - 1 lives in the host
  runtime's coordinator loop (``core/host_runtime.py``).
* ``device_rollout_buffer`` — the zero trajectory the fused runtime's
  carry starts from, where the ring is positional.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class SlabRing:
    """``n_slots`` slab dicts of ``(alpha, n_envs, ...)`` arrays plus a
    bootstrap-observation row block each. Interval ``j``'s executors
    write slab ``j % n_slots`` (slot ``(t, env_id)`` owned by exactly one
    executor thread, so no lock) while up to ``K = n_slots - 1`` earlier
    intervals wait for the learner in the other slots.

    Each slab is a torch tensor with a numpy view over the same memory:
    executors write the view, ``as_traj`` reads the tensor. ``pin=True``
    page-locks the slabs so that ``as_traj`` to a CUDA device is an
    asynchronous copy. On the CPU ``as_traj`` hands the slab over by
    reference, as the reference does.

    The ring discipline: slab ``j % n_slots`` is rewritten at interval
    ``j + n_slots``, and the coordinator waits for the learner pass that
    read interval ``j``'s data (applied at interval ``j + K``) before it
    releases interval ``j + n_slots``'s executors. An asynchronous copy
    out of the slab is part of that pass (the host runtime enqueues it on
    the learner's stream ahead of the gradient), so the same wait covers
    it."""

    def __init__(self, alpha: int, n_envs: int, specs: Dict[str, tuple],
                 n_slots: int = 2, pin: bool = False):
        if n_slots < 2:
            raise ValueError(f"SlabRing needs >= 2 slots, got {n_slots}")

        def alloc(shape, dtype):
            return torch.zeros(shape, dtype=torch.from_numpy(
                np.zeros((), dtype)).dtype, pin_memory=pin)

        obs_shape, obs_dtype = specs["obs"]
        self.n_slots = n_slots
        self.tensors = tuple(
            {k: alloc((alpha, n_envs) + tuple(s), d)
             for k, (s, d) in specs.items()} for _ in range(n_slots))
        self.boot_tensors = tuple(
            alloc((n_envs,) + tuple(obs_shape), obs_dtype)
            for _ in range(n_slots))
        self.slabs = tuple({k: t.numpy() for k, t in slab.items()}
                           for slab in self.tensors)
        self.bootstrap = tuple(t.numpy() for t in self.boot_tensors)

    def write_view(self, j: int):
        """(slab dict, bootstrap row block) interval ``j`` writes into:
        numpy views of the slab's memory."""
        return self.slabs[j % self.n_slots], self.bootstrap[j % self.n_slots]

    def as_traj(self, j: int, device=None) -> Dict[str, torch.Tensor]:
        """Interval ``j``'s finished data as a learner trajectory: the
        slab itself on the CPU, an asynchronous copy on the current
        stream of a CUDA device (it reads the slab after this returns)."""
        device = torch.device("cpu" if device is None else device)
        slot = j % self.n_slots
        out = dict(self.tensors[slot])
        out["bootstrap_obs"] = self.boot_tensors[slot]
        if device.type == "cpu":
            return out
        return {k: v.to(device, non_blocking=True) for k, v in out.items()}


def device_rollout_buffer(n_envs: int, alpha: int, obs_shape, obs_dtype,
                          action_dtype=torch.int32, device=None):
    """Zero-initialized (alpha, n_envs, ...) trajectory for a fused
    runtime's carry, ``dones`` one (every slot starts an episode)."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "obs": zeros((alpha, n_envs) + tuple(obs_shape), obs_dtype),
        "actions": zeros((alpha, n_envs), action_dtype),
        "rewards": zeros((alpha, n_envs), torch.float32),
        "dones": torch.ones((alpha, n_envs), dtype=torch.float32,
                            device=device),
        "behavior_logprob": zeros((alpha, n_envs), torch.float32),
        "bootstrap_obs": zeros((n_envs,) + tuple(obs_shape), obs_dtype),
    }
