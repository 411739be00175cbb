"""Multi-process sharded training: one invocation per process.

Counterpart of ``repro/launch/distributed.py``, with its flags plus
``--device`` (default ``cuda``) and ``--backend``::

    # process 0 (also the coordinator) and process 1, same spec:
    PYTHONPATH=src python -m repro_torch.launch.distributed \
        --spec examples/specs/quickstart.json \
        --coordinator 127.0.0.1:12355 --num-processes 2 --process-id 0 &
    PYTHONPATH=src python -m repro_torch.launch.distributed \
        --spec examples/specs/quickstart.json \
        --coordinator 127.0.0.1:12355 --num-processes 2 --process-id 1

Every process joins the process group (``core/distributed.py``: nccl when
each rank has a GPU of its own, gloo otherwise: on the CPU, or with
several ranks on one GPU, where the gradient sums travel through the
host), builds the same session from the same spec with the runtime
forced to ``sharded``, and runs its rank's envs. Every process prints one
JSON line whose ``params_sha256`` is the digest the 1-process ``mesh``
run of the spec gives. ``batch.n_replicas``, when set, must equal the
number of processes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np


def params_digest(params) -> str:
    """sha256 over a params tree: numpy dtype name and shape, then the
    bytes, leaf by leaf in the port's tree order (``tree_leaves``)."""
    from repro_torch.core.tree import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        arr = np.ascontiguousarray(leaf.detach().cpu().numpy())
        h.update(repr((str(arr.dtype), arr.shape)).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-process sharded HTS-RL (one run per process)")
    ap.add_argument("--spec", required=True, help="experiment spec JSON")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0 (or a tcp:// / file:// "
                    "init URL)")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--intervals", type=int, default=None,
                    help="override spec.intervals")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl when every rank has a GPU of its "
                    "own, else gloo")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    from repro_torch import api, resolve_device
    from repro_torch.core import distributed

    resolve_device(args.device)          # no CUDA and no "cpu": raise
    backend = distributed.initialize(
        args.coordinator, args.num_processes, args.process_id,
        backend=args.backend, device=args.device)
    try:
        device = distributed.rank_device(args.device, backend,
                                         args.process_id)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        spec = api.load(args.spec)
        if spec.runtime.name != "sharded":
            spec = spec.replace(runtime="sharded")
        group = distributed.global_data_group(
            n_replicas=spec.batch.n_replicas)
        session = api.build(spec, device=device, group=group)
        n = args.intervals if args.intervals is not None else spec.intervals
        out = session.run(n)
        print(json.dumps({
            "process": args.process_id,
            "num_processes": args.num_processes,
            "devices": torch.distributed.get_world_size(),
            "intervals": n,
            "geometry": session.runtime.geometry.canonical(),
            "params_sha256": params_digest(out.params),
            "sps": round(out.sps, 1),
            "backend": backend,
            "device": str(device),
            "gather": distributed.gather_route(group, device),
        }))
        sys.stdout.flush()
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
