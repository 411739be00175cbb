"""Production mesh definitions (NVIDIA H100 SXM5 numbers).

Counterpart of ``repro/launch/mesh.py``. Functions, not module
constants: importing this module touches no process group and no device.

``make_production_mesh`` builds a ``DeviceMesh`` over the live process
group: ``("data", "model") = (32, 8)`` on 256 ranks (``pod``) and
``("pod", "data", "model") = (2, 32, 8)`` on 512 (``multipod``). The
reference's chip counts are kept so the dry run's rows pair with its
own; the ``model`` axis is one NVLink node of 8 GPUs, since tensor
parallelism past a node would cross InfiniBand (the v5e torus let the
reference take 16). ``make_host_mesh`` is a 1-D ``("data",)`` mesh over
the group's world, or ``None`` with no process group (one rank).

``use_mesh`` installs the mesh ``sharding.constraints.constrain`` reads;
``as_placements`` turns a tree of ``sharding.rules.P`` specs into
placements, the counterpart of ``as_shardings``. The reference's
jax-version shims (``AxisType``, the ``set_mesh`` fallback) have no
counterpart.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

# NVIDIA H100 SXM5 80GB datasheet (the card of the records: NVIDIA H100
# 80GB HBM3, 700 W): dense BF16 tensor-core peak, HBM3 bandwidth and
# capacity, NVLink 4 at 900 GB/s bidirectional (450 GB/s each way), and
# one 400 Gb/s InfiniBand NIC per GPU.
PEAK_FLOPS_BF16 = 989.4e12      # per GPU, dense
HBM_BW = 3.35e12                # bytes/s per GPU
HBM_BYTES = 80e9                # per GPU
NVLINK_BW = 450e9               # bytes/s per GPU, per direction
IB_BW = 50e9                    # bytes/s per GPU (400 Gb/s)
GPUS_PER_NODE = 8

POD_SHAPE = (32, 8)
POD_AXES = ("data", "model")
MULTIPOD_SHAPE = (2, 32, 8)
MULTIPOD_AXES = ("pod", "data", "model")

_ACTIVE: list = []


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device_type) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The ``pod`` or ``multipod`` mesh over the live process group;
    raises unless the group's world is exactly its rank count."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTIPOD_AXES if multi_pod else POD_AXES
    need, have = math.prod(shape), _world()
    if have != need:
        raise ValueError(
            f"the {'multipod' if multi_pod else 'pod'} mesh {shape} over "
            f"{axes} needs a process group of {need} ranks; this one has "
            f"{have}")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device_type=None):
    """The group's world as a 1-D ``("data",)`` mesh; ``None`` when no
    process group is up (one rank, no sharding)."""
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type), (_world(),),
                            mesh_dim_names=("data",))


def active_mesh():
    """The mesh ``use_mesh`` installed, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for ``constrain`` for the duration of the block
    (``None`` installs nothing)."""
    if mesh is None:
        yield None
        return
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a stand-in with
    its ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def as_placements(mesh, spec_tree):
    """A tree of ``rules.P`` specs -> the same tree of placement tuples."""
    from repro_torch.sharding import rules
    return rules.map_specs(lambda _, s: rules.to_placements(s, mesh),
                           spec_tree, spec_tree)
