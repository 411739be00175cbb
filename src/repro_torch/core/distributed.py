"""Multi-process data parallelism: ``torch.distributed`` wiring for the
sharded runtime.

Counterpart of ``repro/core/distributed.py``. One process per replica
joins a process group; the sharded runtime (``core/sharded_runtime.py``)
then runs on every rank the fused interval over that rank's env rows,
and ranks exchange exactly one thing per logical step: the canonical
gradient SUM, all-gathered in rank order and combined by the pairwise
tree (``core/mesh_runtime.make_learner_update``). The determinism
contract (env ids offset by rank, the canonical reduction) makes N
ranks produce the 1-process mesh run's parameters bit for bit.

Backends are explicit, and a setup the backend cannot serve fails here,
never by falling back to another one:

  * ``nccl`` needs a CUDA device per rank (NCCL refuses two ranks on
    one GPU); rank r runs on ``cuda:r``. The default on CUDA when every
    rank has its own GPU.
  * ``gloo`` otherwise: on the CPU, or with several ranks sharing the
    GPUs (rank r on ``cuda:(r mod device_count)``). gloo's collectives
    are not documented for CUDA tensors, so a CUDA tensor is copied to
    the host, gathered there and copied back (``gather_route``): only
    the transfer takes that way, every computation stays on the card.

Entry point: ``python -m repro_torch.launch.distributed`` (one
invocation per process).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "global_data_group",
           "default_backend", "rank_device", "gather_route",
           "rank_and_size", "all_gather_stack", "all_gather_cat"]

BACKENDS = ("nccl", "gloo")
# process 0's store listens on this inherited file descriptor, a socket
# bound to the coordinator's port, when the variable is set
STORE_FD_ENV = "REPRO_TORCH_STORE_FD"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def default_backend(device, num_processes: int) -> str:
    """``nccl`` for a CUDA device when every rank has a GPU of its own,
    ``gloo`` otherwise."""
    dev = torch.device(device)
    if (dev.type == "cuda" and torch.cuda.is_available()
            and num_processes <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _check_backend(backend: str, device, num_processes: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose one of "
                         f"{list(BACKENDS)}")
    if backend != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"backend 'nccl' runs on CUDA devices, not {str(dev)!r}; use "
            f"'gloo' for the CPU")
    n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if num_processes > n_gpus:
        raise ValueError(
            f"backend 'nccl' needs one GPU per rank: {num_processes} "
            f"process(es) but {n_gpus} GPU(s) (NCCL refuses two ranks on "
            f"one GPU); use 'gloo' to share GPUs between ranks")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               device="cuda") -> str:
    """Join (or form) the process group; returns its backend.
    Idempotent: a second call with the same topology returns at once,
    one with another topology raises.

    ``coordinator_address`` is process 0's ``host:port`` (or a
    ``tcp://`` / ``file://`` init URL); ``backend`` defaults to
    ``default_backend(device, num_processes)``."""
    if num_processes < 1 or not (0 <= process_id < num_processes):
        raise ValueError(
            f"bad process topology: process_id={process_id}, "
            f"num_processes={num_processes}")
    if is_initialized():
        have = (dist.get_world_size(), dist.get_rank())
        if have != (num_processes, process_id):
            raise ValueError(
                f"process group already initialized as rank {have[1]} of "
                f"{have[0]}; asked for rank {process_id} of "
                f"{num_processes}")
        return dist.get_backend()
    backend = backend or default_backend(device, num_processes)
    _check_backend(backend, device, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id)
    if coordinator_address.startswith("file://"):
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(
            backend, store=_tcp_store(coordinator_address, num_processes,
                                      process_id),
            world_size=num_processes, rank=process_id)
    return backend


def _tcp_store(address: str, num_processes: int, process_id: int):
    """The rendezvous store at ``host:port`` (or ``tcp://host:port``),
    the same on every rank: process 0 serves it, the others connect.
    With ``STORE_FD_ENV`` set, process 0 serves it on that inherited
    socket, already bound to the port, so a caller that picked a free
    port by binding it keeps the port until the store listens (closing
    the probe and binding again could lose it to another process)."""
    host, _, port = address.removeprefix("tcp://").rpartition(":")
    master = process_id == 0
    fd = os.environ.get(STORE_FD_ENV) if master else None
    return dist.TCPStore(host, int(port), num_processes, is_master=master,
                         master_listen_fd=None if fd is None else int(fd))


def rank_device(device, backend: str, rank: int) -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:rank`` under nccl,
    ``cuda:(rank mod device_count)`` under gloo, the CPU as given."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = rank if backend == "nccl" else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def global_data_group(n_replicas: Optional[int] = None):
    """The group over every rank (the default group).

    ``n_replicas`` must equal the world size when given: a group over
    only some ranks would leave the rest running a program they hold no
    envs of, so that is refused."""
    if not is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized; call "
            "repro_torch.core.distributed.initialize first")
    world = dist.get_world_size()
    if n_replicas is not None and n_replicas != world:
        raise ValueError(
            f"batch.n_replicas={n_replicas} != {world} global rank(s); "
            f"in the multi-process path every rank is a replica — size "
            f"the process topology to the geometry")
    return dist.group.WORLD


def rank_and_size(group) -> tuple:
    """(this process's rank in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def gather_route(group, device) -> str:
    """How a collective on ``device`` travels in ``group``: ``"device"``
    (nccl, or gloo on the CPU) or ``"host"`` (gloo with CUDA tensors:
    copied to the host, gathered, copied back)."""
    on_card = torch.device(device).type == "cuda"
    if on_card and dist.get_backend(group) != "nccl":
        return "host"
    return "device"


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (size, *x.shape). An
    exact copy of each rank's bits; bool tensors travel as uint8."""
    _, size = rank_and_size(group)
    send = x.contiguous()
    if gather_route(group, x.device) == "host":
        send = send.cpu()
    if send.dtype == torch.bool:
        send = send.view(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    out = torch.stack(parts)
    if x.dtype == torch.bool:
        out = out.view(torch.bool)
    return out.to(x.device)


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return torch.cat(list(all_gather_stack(x, group).unbind(0)), dim=dim)
