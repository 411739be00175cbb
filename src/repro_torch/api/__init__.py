"""repro_torch.api — the declarative experiment surface (counterpart of
``repro.api``).

One ``ExperimentSpec`` (env x policy x optimizer x algorithm x runtime
x HTSConfig knobs x checkpoint policy, every axis a registry name) and
one verb:

    from repro_torch import api

    spec = api.load("examples/specs/quickstart.json")
    session = api.build(spec)               # on cuda; device="cpu" to ask
    out = session.run(400)                  # engine RunResult
    report = session.fit(resume=True)       # checkpointed (spec.checkpoint)

The command line over it is ``python -m repro_torch.launch.run``.
"""
from repro_torch.api.session import Session, build, runtime_names  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    CheckpointSpec, ComponentSpec, ExperimentSpec, diff_canonical,
    dumps, from_dict, load, loads, save, workload_fingerprint)
from repro_torch.core.batch import BatchConfig  # noqa: F401
from repro_torch.faults import FaultEvent, FaultPlan  # noqa: F401
from repro_torch.serve.config import ServeConfig  # noqa: F401
