"""Logical activation-sharding constraints.

Counterpart of ``repro/sharding/constraints.py``. ``constrain(x,
*logical)`` pins an activation's layout at the reference's points
(residual stream, attention tiles, MoE dispatch, the scans' inputs, the
loss chunks), resolved as the param rules resolve, against the mesh
``launch.mesh.use_mesh`` installed. On a ``DTensor`` it is
``x.redistribute`` to those placements (a differentiable collective);
GSPMD's ``with_sharding_constraint`` is the same pin. The identity when
no mesh is active or ``x`` is a plain tensor: every single-device run
is unchanged.
"""
from __future__ import annotations

from repro_torch.launch.mesh import active_mesh, axis_sizes
from repro_torch.sharding import rules


def constrained_spec(shape, logical, mesh):
    """The spec ``constrain`` pins: ``rules.resolve``, but an axis group
    of size 1 is not assigned (the reference's ``total > 1``)."""
    sizes = axis_sizes(mesh)
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical):
        assigned = None
        for cand in rules.MESH_MAP.get(name, ((),)):
            cand = tuple(a for a in cand if a in sizes)
            if not cand or any(a in used for a in cand):
                continue
            total = 1
            for a in cand:
                total *= sizes[a]
            if total > 1 and dim % total == 0 and dim >= total:
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        spec.append(assigned)
    return rules.P(*spec)


def constrain(x, *logical):
    """Redistribute a ``DTensor`` to ``resolve(logical)`` on the active
    mesh; anything else passes through."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = constrained_spec(tuple(x.shape), logical, mesh)
    if not any(s is not None for s in spec):
        return x
    placements = rules.to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def gather_fsdp(w):
    """A ``DTensor`` weight gathered over the data axes (``pod``,
    ``data``), its ``model`` split kept: the FSDP all-gather before a
    layer's products, whose gradient is the reduce-scatter back. GSPMD
    picks this for the reference; DTensor's per-op choice may instead
    gather the activations' batch, every rank then computing the whole
    batch. The identity for anything else."""
    if active_mesh() is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if n in ("pod", "data") else p
          for n, p in zip(names, w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)

