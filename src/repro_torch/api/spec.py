"""ExperimentSpec: the declarative description of one experiment.

Counterpart of ``repro/api/spec.py``, copied with the port's
``BatchConfig``, ``HTSConfig``, ``FaultPlan``, ``ServeConfig``,
``TenancyConfig`` and device-port lookup: every spec the reference
accepts parses, validates and canonicalizes the same way here, byte for
byte (``dumps``, ``workload_fingerprint``), including specs whose
runtime or env the port cannot build yet; ``api.build`` says so.

One typed, JSON-round-trippable value names everything a run needs —
environment x policy x optimizer x algorithm x runtime x HTSConfig
knobs x checkpoint policy — each axis resolved through its registry at
``api.build`` time:

    spec = ExperimentSpec(env="catch", policy="mlp", runtime="mesh",
                          hts={"alpha": 8, "n_envs": 16})
    session = api.build(spec)
    out = session.run(400)

Validation is eager and loud: unknown field names, ``staleness < 1``,
``alpha < 1`` and friends raise at construction/``loads`` time with the
offending field named. Registry-name existence is checked at ``build``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from repro_torch.core.batch import BatchConfig
from repro_torch.core.engine import HTSConfig
from repro_torch.faults import FaultPlan
from repro_torch.serve.config import ServeConfig
from repro_torch.tenancy.config import TenancyConfig

# HTSConfig knobs a spec may set. ``algorithm`` is excluded: it is a
# first-class spec axis (``ExperimentSpec.algorithm``), and allowing it
# in both places would invite the two disagreeing silently.
_HTS_FIELDS = tuple(f for f in HTSConfig._fields if f != "algorithm")


def _jsonable(value, where: str):
    """Reject values that would not survive a JSON round-trip (function
    objects, device arrays, Mesh handles...) with the field named."""
    try:
        return json.loads(json.dumps(value))
    except (TypeError, ValueError):
        raise TypeError(
            f"{where} is not JSON-serializable: {value!r}; pass live "
            f"objects (meshes, callables) as build(spec, ...) overrides "
            f"instead of putting them in the spec") from None


@dataclass(frozen=True)
class ComponentSpec:
    """A registry name plus construction kwargs."""
    name: str
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def canonical(self) -> dict:
        return {"name": self.name,
                "kwargs": _jsonable(dict(self.kwargs), self.name)}

    @staticmethod
    def of(value: Union[str, dict, "ComponentSpec"],
           where: str) -> "ComponentSpec":
        if isinstance(value, ComponentSpec):
            return value
        if isinstance(value, str):
            return ComponentSpec(value)
        if isinstance(value, dict):
            unknown = set(value) - {"name", "kwargs"}
            if unknown:
                raise ValueError(
                    f"unknown {where} field(s) {sorted(unknown)}; a "
                    f"component is {{'name': ..., 'kwargs': {{...}}}}")
            if "name" not in value:
                raise ValueError(f"{where} needs a 'name'")
            return ComponentSpec(value["name"],
                                 dict(value.get("kwargs", {})))
        raise TypeError(f"{where} must be a name, dict, or "
                        f"ComponentSpec, got {type(value).__name__}")


@dataclass(frozen=True)
class CheckpointSpec:
    """Checkpoint/eval policy for ``Session.fit`` (core/trainer.py)."""
    dir: Optional[str] = None
    every: int = 0               # intervals per segment (0: one segment)
    keep: int = 3                # most-recent checkpoints retained

    def canonical(self) -> dict:
        return {"dir": self.dir, "every": int(self.every),
                "keep": int(self.keep)}

    @staticmethod
    def of(value) -> "CheckpointSpec":
        if isinstance(value, CheckpointSpec):
            return value
        if value is None:
            return CheckpointSpec()
        if isinstance(value, dict):
            unknown = set(value) - {"dir", "every", "keep"}
            if unknown:
                raise ValueError(
                    f"unknown checkpoint field(s) {sorted(unknown)}; "
                    f"known: ['dir', 'every', 'keep']")
            return CheckpointSpec(**value)
        raise TypeError(f"checkpoint must be a dict or CheckpointSpec, "
                        f"got {type(value).__name__}")


@dataclass(frozen=True)
class ExperimentSpec:
    env: ComponentSpec = field(default_factory=lambda: ComponentSpec("catch"))
    policy: ComponentSpec = field(default_factory=lambda: ComponentSpec("mlp"))
    optimizer: ComponentSpec = field(
        default_factory=lambda: ComponentSpec("rmsprop", {"lr": 7e-4}))
    algorithm: str = "a2c"
    runtime: ComponentSpec = field(default_factory=lambda: ComponentSpec("mesh"))
    hts: Dict[str, Any] = field(default_factory=dict)  # HTSConfig knobs
    params_seed: int = 0         # PRNG key for policy.init
    intervals: int = 100         # default run length (Session.run())
    checkpoint: CheckpointSpec = field(default_factory=CheckpointSpec)
    # serving policy for Session.serve() (repro.serve): dispatch width,
    # admission bound, dispatcher wait. Validated eagerly by ServeConfig
    # itself; popped from workload_fingerprint (it changes serving
    # latency, never what a training number means).
    serve: ServeConfig = field(default_factory=ServeConfig)
    # chaos schedule + recovery policy (repro.faults, DESIGN.md §11):
    # one seeded FaultPlan spans training (host pool sites, trainer
    # checkpoint site) and serving (dispatcher site) — Session.build
    # arms ONE shared FaultInjector from it. Popped from
    # workload_fingerprint: by the recovery guarantee, faults change
    # wall time, never what a result means.
    faults: FaultPlan = field(default_factory=FaultPlan)
    # batch geometry (repro.core.batch, DESIGN.md §12):
    # global_batch (= hts.n_envs) factorized as
    # micro_batch x grad_accumulation x n_replicas. Validated eagerly
    # against hts.n_envs here; threaded into the runtime by
    # Session.build. Default (all None/1) reproduces the legacy
    # runtime-determined geometry exactly — and is popped from
    # workload_fingerprint so committed baselines stay comparable.
    batch: BatchConfig = field(default_factory=BatchConfig)
    # multi-tenant scheduling block (repro.tenancy, DESIGN.md §13):
    # fair-share weight, grant quantum, and tenant name consumed when
    # this spec is admitted into a TenantPool. Popped from
    # workload_fingerprint always — by the multiplexing-determinism
    # contract, scheduling share changes WHEN intervals run, never what
    # they compute.
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)

    def __post_init__(self):
        object.__setattr__(self, "env", ComponentSpec.of(self.env, "env"))
        object.__setattr__(self, "policy",
                           ComponentSpec.of(self.policy, "policy"))
        object.__setattr__(self, "optimizer",
                           ComponentSpec.of(self.optimizer, "optimizer"))
        object.__setattr__(self, "runtime",
                           ComponentSpec.of(self.runtime, "runtime"))
        object.__setattr__(self, "hts", dict(self.hts))
        object.__setattr__(self, "checkpoint",
                           CheckpointSpec.of(self.checkpoint))
        object.__setattr__(self, "serve", ServeConfig.of(self.serve))
        object.__setattr__(self, "faults", FaultPlan.of(self.faults))
        object.__setattr__(self, "batch", BatchConfig.of(self.batch))
        object.__setattr__(self, "tenancy", TenancyConfig.of(self.tenancy))
        self._validate()

    def _validate(self) -> None:
        unknown = set(self.hts) - set(_HTS_FIELDS)
        if unknown:
            hint = (" (set spec.algorithm, not hts['algorithm'])"
                    if "algorithm" in unknown else "")
            raise ValueError(
                f"unknown HTSConfig knob(s) {sorted(unknown)}{hint}; "
                f"known: {sorted(_HTS_FIELDS)}")
        cfg = self.hts_config()
        if cfg.alpha < 1:
            raise ValueError(f"alpha must be >= 1, got {cfg.alpha}")
        if cfg.n_envs < 1:
            raise ValueError(f"n_envs must be >= 1, got {cfg.n_envs}")
        if cfg.staleness < 1:
            raise ValueError(
                f"staleness must be >= 1, got {cfg.staleness}")
        if cfg.env_backend not in ("host", "device"):
            raise ValueError(
                f"unknown env_backend {cfg.env_backend!r}; choose 'host' "
                f"(vmapped scalar envs) or 'device' (device-resident "
                f"batched port)")
        if cfg.env_backend == "device":
            # spec-time, not trace-time: an env without a device port
            # (football, token — their step logic is host-side) must
            # fail here with the supported pairs spelled out, not deep
            # inside runtime construction or jit tracing
            from repro_torch.envs.device import (device_port_names,
                                                 has_device_port)
            if not has_device_port(self.env.name):
                raise ValueError(
                    f"env {self.env.name!r} has no device-resident port, "
                    f"so hts['env_backend']='device' is unsupported for "
                    f"it; envs with device ports: "
                    f"{sorted(device_port_names())}. Use the default "
                    f"env_backend='host' for {self.env.name!r}.")
        # geometry checks need the global batch (n_envs): divisibility
        # and the power-of-two alignment of the bit-exactness contract,
        # rejected spec-side with the offending batch.<field> named and
        # the nearest valid factorization suggested (repro.core.batch)
        self.batch.resolve(cfg.n_envs)
        if self.intervals < 0:
            raise ValueError(
                f"intervals must be >= 0, got {self.intervals}")
        if self.checkpoint.every < 0 or self.checkpoint.keep < 0:
            raise ValueError(
                f"checkpoint.every/keep must be >= 0, got "
                f"{self.checkpoint.every}/{self.checkpoint.keep}")

    # ------------------------------------------------------ serialization
    def hts_config(self) -> HTSConfig:
        return HTSConfig(algorithm=self.algorithm, **self.hts)

    def canonical(self) -> dict:
        """The fully-explicit JSON form: every field present (including
        defaults), component kwargs verified JSON-round-trippable. Equal
        specs have equal canonical dicts and equal ``dumps`` strings."""
        return {
            "env": self.env.canonical(),
            "policy": self.policy.canonical(),
            "optimizer": self.optimizer.canonical(),
            "algorithm": self.algorithm,
            "runtime": self.runtime.canonical(),
            "hts": _jsonable(dict(self.hts), "hts"),
            "params_seed": int(self.params_seed),
            "intervals": int(self.intervals),
            "checkpoint": self.checkpoint.canonical(),
            "serve": self.serve.canonical(),
            "faults": self.faults.canonical(),
            "batch": self.batch.canonical(),
            "tenancy": self.tenancy.canonical(),
        }

    def replace(self, **changes) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)


_SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(ExperimentSpec))


def from_dict(d: dict) -> ExperimentSpec:
    if not isinstance(d, dict):
        raise TypeError(f"spec must be a JSON object, got "
                        f"{type(d).__name__}")
    unknown = set(d) - set(_SPEC_FIELDS)
    if unknown:
        raise ValueError(f"unknown spec field(s) {sorted(unknown)}; "
                         f"known: {sorted(_SPEC_FIELDS)}")
    return ExperimentSpec(**d)


def dumps(spec: ExperimentSpec, indent: Optional[int] = None) -> str:
    """Canonical JSON serialization (sorted keys, every field explicit).
    ``loads(dumps(spec))`` == ``spec``."""
    return json.dumps(spec.canonical(), sort_keys=True, indent=indent)


def loads(s: str) -> ExperimentSpec:
    return from_dict(json.loads(s))


def load(path: str) -> ExperimentSpec:
    with open(path) as f:
        return from_dict(json.load(f))


def save(spec: ExperimentSpec, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(spec, indent=2) + "\n")


def workload_fingerprint(spec: ExperimentSpec) -> dict:
    """Everything about the spec that changes what a throughput or
    learning-curve number *means* — the canonical form minus run length
    and checkpoint policy (recorded separately by the bench harness).
    benchmarks/check_sps.py compares records by this dict and prints a
    field-level diff on mismatch."""
    fp = spec.canonical()
    fp.pop("intervals")
    fp.pop("checkpoint")
    # the serve block shapes request latency, not the training workload;
    # keeping it out preserves comparability with every committed
    # pre-serve record (benchmarks/serve_bench.py re-adds it to ITS
    # records, where max_batch does change what a QPS number means)
    fp.pop("serve")
    # faults likewise: the recovery guarantee (DESIGN.md §11) is exactly
    # that a faulted run's results MEAN the same as the fault-free
    # run's — only wall time differs, and the bench harness records
    # that separately (benchmarks/recovery_bench.py)
    fp.pop("faults")
    # DEFAULT batch geometry is popped so every committed pre-BatchConfig
    # record stays byte-comparable; a NON-default geometry stays in —
    # replica count and accumulation change the execution schedule, so
    # check_sps must never compare SPS across geometries (the
    # determinism contract makes the RESULTS equal, not the timings)
    if spec.batch.is_default:
        fp.pop("batch")
    # tenancy is popped ALWAYS: by the multiplexing-determinism contract
    # (DESIGN.md §13) a tenant's results are bit-exact to its solo run
    # at any weight/quantum — scheduling share changes when intervals
    # run, never what they compute, so pooled and solo records of the
    # same workload must stay comparable
    fp.pop("tenancy")
    return fp


def diff_canonical(a: dict, b: dict, prefix: str = "") -> list:
    """Field-level differences between two canonical spec dicts, as
    ``path: a_value != b_value`` strings (recursing into nested
    objects) — what check_sps prints instead of an opaque
    "fingerprint differs"."""
    out = []
    if isinstance(a, dict) and isinstance(b, dict):
        for key in sorted(set(a) | set(b)):
            path = f"{prefix}.{key}" if prefix else key
            if key not in a:
                out.append(f"{path}: <absent> != {b[key]!r}")
            elif key not in b:
                out.append(f"{path}: {a[key]!r} != <absent>")
            else:
                out.extend(diff_canonical(a[key], b[key], path))
    elif a != b:
        out.append(f"{prefix or '<root>'}: {a!r} != {b!r}")
    return out
