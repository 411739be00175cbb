"""BatchConfig: typed batch geometry, and the canonical reduction that
makes it bit-exact.

Counterpart of ``repro/core/batch.py``: ``BatchConfig`` and its
validation are the reference's own pure-Python code, copied (the port
imports nothing of ``repro``); ``pairwise_tree_sum`` is on tensors.

    global_batch = micro_batch x grad_accumulation x n_replicas

``n_envs`` (HTSConfig) is the global batch. Per-env gradients are summed
by the adjacent-pairwise tree over the global env index in fp32, and
divided once by the global batch. A contiguous block of
``micro_batch = 2^d`` envs is then an exact subtree of that tree, so any
factorization whose blocks align with subtrees computes the identical
float. The validation rules are that alignment condition:

  * ``global_batch % (grad_accumulation * n_replicas) == 0``
  * ``micro_batch`` (the block size) is a power of two
  * ``grad_accumulation`` is a power of two
  * ``n_replicas`` is unconstrained beyond divisibility.

``grad_accumulation * n_replicas == 1`` imposes nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import torch

__all__ = ["BatchConfig", "ResolvedBatch", "pairwise_tree_sum"]


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def pairwise_tree_sum(x):
    """Adjacent-pairwise tree sum over dim 0, in the reference's order:
    level by level, element ``2i`` is added to ``2i+1``; an odd leftover
    rides along unmodified to the next level. Equal-size contiguous
    blocks of power-of-two width are exact subtrees, so a hierarchical
    (block, then over blocks) reduction is bit-identical to the flat
    one."""
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        paired = x[0:2 * half:2] + x[1:2 * half:2]
        if n % 2:
            paired = torch.cat([paired, x[n - 1:n]], dim=0)
        x = paired
    return x[0]


class ResolvedBatch(NamedTuple):
    """A concrete geometry: every axis an int, product == global."""
    micro_batch: int
    grad_accumulation: int
    n_replicas: int
    global_batch: int

    @property
    def chunks(self) -> int:
        """Total gradient blocks per interval (accumulation x replicas)
        — what a single-process runtime scans over to reproduce the
        multi-replica reduction bit-exactly."""
        return self.grad_accumulation * self.n_replicas

    def canonical(self) -> dict:
        return {"micro_batch": int(self.micro_batch),
                "grad_accumulation": int(self.grad_accumulation),
                "n_replicas": int(self.n_replicas),
                "global_batch": int(self.global_batch)}


def _valid_factorizations(n_envs: int):
    """All (grad_accumulation, n_replicas) the alignment rules accept
    for this global batch."""
    out = []
    a = 1
    while a <= n_envs:
        for r in range(1, n_envs // a + 1):
            if n_envs % (a * r) == 0 and (
                    a * r == 1 or _is_pow2(n_envs // (a * r))):
                out.append((a, r))
        a *= 2
    return out


def _nearest_valid(n_envs: int, a: int, r: int) -> str:
    """The suggestion string for rejection errors: the accepted
    (grad_accumulation, n_replicas) closest to what was asked."""
    best = min(_valid_factorizations(n_envs),
               key=lambda ar: (abs(ar[0] - a) + abs(ar[1] - r), ar[0] + ar[1]))
    return (f"nearest valid factorization for global_batch={n_envs}: "
            f"grad_accumulation={best[0]}, n_replicas={best[1]} "
            f"(micro_batch={n_envs // (best[0] * best[1])})")


@dataclass(frozen=True)
class BatchConfig:
    """The spec's ``batch`` block. All fields optional:

    * ``micro_batch``        — envs per gradient microbatch (per
      replica). ``None``: derived as
      ``n_envs // (grad_accumulation * n_replicas)``.
    * ``grad_accumulation``  — microbatches accumulated (in fp32)
      before the one optimizer step per interval.
    * ``n_replicas``         — data-parallel replicas. ``None``: the
      runtime decides (1 for host/mesh; every device on the mesh for
      sharded — the pre-BatchConfig behavior, preserved exactly).

    Field-level checks run eagerly here; the geometry checks (which
    need ``n_envs``) run in :meth:`resolve` — ``ExperimentSpec``
    validation calls it, so a bad spec still fails at construction
    time with the offending ``batch.<field>`` named."""
    micro_batch: Optional[int] = None
    grad_accumulation: int = 1
    n_replicas: Optional[int] = None

    def __post_init__(self):
        for name in ("micro_batch", "n_replicas"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 1):
                raise ValueError(
                    f"batch.{name} must be a positive int or null, "
                    f"got {v!r}")
        a = self.grad_accumulation
        if not isinstance(a, int) or isinstance(a, bool) or a < 1:
            raise ValueError(
                f"batch.grad_accumulation must be a positive int, "
                f"got {a!r}")

    @property
    def is_default(self) -> bool:
        return (self.micro_batch is None and self.grad_accumulation == 1
                and self.n_replicas is None)

    # ------------------------------------------------------ resolution
    def resolve(self, n_envs: int, default_replicas: int = 1,
                strict: Optional[bool] = None) -> ResolvedBatch:
        """Concretize against the global batch (``n_envs``).

        ``default_replicas`` fills ``n_replicas=None`` (the runtime's
        legacy replica count). ``strict`` controls the power-of-two
        alignment rules of the bit-exactness contract: default is
        strict exactly when the config is non-default — an explicitly
        configured geometry must honor the contract, while legacy
        runtime-determined geometry (e.g. a 3-device mesh) keeps
        working with divisibility checks only."""
        if strict is None:
            strict = not self.is_default
        a = self.grad_accumulation
        r = self.n_replicas
        if r is None and self.micro_batch is not None:
            # micro_batch + accumulation given: replicas derived from
            # global_batch = micro_batch * grad_accumulation * n_replicas
            per = self.micro_batch * a
            if n_envs % per:
                raise ValueError(
                    f"batch.micro_batch={self.micro_batch} x "
                    f"batch.grad_accumulation={a} = {per} does not "
                    f"divide global_batch (hts.n_envs) = {n_envs}; "
                    + _nearest_valid(n_envs, a, max(1, n_envs // per)))
            r = n_envs // per
        elif r is None:
            r = default_replicas
        chunks = a * r
        if n_envs % chunks:
            raise ValueError(
                f"batch.grad_accumulation={a} x batch.n_replicas={r} = "
                f"{chunks} does not divide global_batch (hts.n_envs) = "
                f"{n_envs}; " + _nearest_valid(n_envs, a, r))
        micro = n_envs // chunks
        if strict and chunks > 1:
            if not _is_pow2(a):
                raise ValueError(
                    f"batch.grad_accumulation={a} must be a power of "
                    f"two (the within-replica combine must be a "
                    f"subtree of the canonical reduction tree); "
                    + _nearest_valid(n_envs, a, r))
            if not _is_pow2(micro):
                raise ValueError(
                    f"batch.grad_accumulation={a} x "
                    f"batch.n_replicas={r} gives micro_batch={micro}, "
                    f"which must be a power of two for blocks to align "
                    f"with the canonical reduction tree; "
                    + _nearest_valid(n_envs, a, r))
        if self.micro_batch is not None and self.micro_batch != micro:
            raise ValueError(
                f"batch.micro_batch={self.micro_batch} inconsistent: "
                f"global_batch (hts.n_envs) = {n_envs} with "
                f"grad_accumulation={a}, n_replicas={r} implies "
                f"micro_batch={micro} "
                f"(global = micro x accumulation x replicas); "
                + _nearest_valid(n_envs, a, r))
        return ResolvedBatch(micro, a, r, n_envs)

    # --------------------------------------------------- serialization
    def canonical(self) -> dict:
        return {"micro_batch": self.micro_batch,
                "grad_accumulation": int(self.grad_accumulation),
                "n_replicas": self.n_replicas}

    @staticmethod
    def of(value: Union[None, dict, "BatchConfig"]) -> "BatchConfig":
        if isinstance(value, BatchConfig):
            return value
        if value is None:
            return BatchConfig()
        if isinstance(value, dict):
            unknown = set(value) - {"micro_batch", "grad_accumulation",
                                    "n_replicas"}
            if unknown:
                raise ValueError(
                    f"unknown batch field(s) {sorted(unknown)}; known: "
                    f"['grad_accumulation', 'micro_batch', "
                    f"'n_replicas']")
            return BatchConfig(**value)
        raise TypeError(f"batch must be a dict or BatchConfig, got "
                        f"{type(value).__name__}")
