"""Logical-axis sharding rules -> partition specs, divisibility-aware.

Counterpart of ``repro/sharding/rules.py``: the same ``MESH_MAP``, the
same greedy assignment (``resolve``), the same batch and KV-cache
priorities (``batch_pspec``, ``_kv_cache_spec``). Every parameter gets
logical dimension names from its leaf name and rank; logical names map
to candidate mesh axes in priority order, and a mesh axis is assigned to
a dim only if the dim divides by the axis size and the axis is not used
already in that spec.

A spec is ``P``, a tuple of per-dim entries (``None``, an axis name, or a
tuple of axis names), trailing ``None``s trimmed, as the reference's
``PartitionSpec``. ``to_placements(spec, mesh)`` turns one into DTensor
placements: a dim sharded over two axes is ``Shard(d)`` on both mesh
dims (DTensor splits it in mesh-dim order, which is the reference's
order for ``("pod", "data")``).

The port's parameters are a flat ``{name: tensor}`` dict, one entry per
layer, so there is no stacked leading dim to skip; the leaf name is the
last component of the dotted name, and the port's 2-D ``embed`` is the
reference's ``table``. Caches are a list of per-layer dicts.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.launch.mesh import axis_sizes


class P(tuple):
    """A partition spec: one entry per dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# logical name -> candidate mesh-axis groups, in priority order.
MESH_MAP: Dict[Optional[str], Tuple[Tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",)),
    "embed": (("data",),),          # FSDP: d_model param dim over data
    "dsq": (("model",),),           # second d_model dim of square weights
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (("model",),),
    "ffn": (("model",),),
    "experts": (("model",),),
    # KV-cache sequence dim: over the data axes when the batch dim could
    # not use them
    "seq_data": (("pod", "data"), ("data",)),
    # residual-stream sequence dim: sequence parallelism over model
    "seq_model": (("model",),),
    "frames": ((),),
    None: ((),),
}

# leaf name + rank -> logical dims
PARAM_RULES: Dict[Tuple[str, int], Tuple[Optional[str], ...]] = {
    ("embed", 2): ("vocab", "embed"),
    ("wq", 3): ("embed", "heads", "head_dim"),
    ("wk", 3): ("embed", "kv_heads", "head_dim"),
    ("wv", 3): ("embed", "kv_heads", "head_dim"),
    ("wo", 3): ("heads", "head_dim", "embed"),
    ("w_in", 2): ("embed", "ffn"),
    ("w_gate", 2): ("embed", "ffn"),
    ("w_out", 2): ("ffn", "embed"),
    ("w_in", 3): ("experts", "embed", "ffn"),       # MoE expert weights
    ("w_gate", 3): ("experts", "embed", "ffn"),
    ("w_out", 3): ("experts", "ffn", "embed"),
    ("router", 2): ("embed", "experts"),
    ("w_x_branch", 2): ("embed", "dsq"),
    ("w_gate_branch", 2): ("embed", "dsq"),
    ("w_a", 2): ("embed", "dsq"),
    ("w_i", 2): ("embed", "dsq"),
    ("w_r", 2): ("embed", "dsq"),
    ("w_k", 2): ("embed", "dsq"),
    ("w_v", 2): ("embed", "dsq"),
    ("w_g", 2): ("embed", "dsq"),
    ("w_o", 2): ("embed", "dsq"),
    ("w_lora_a", 2): ("embed", None),
    ("w_lora_b", 2): (None, "dsq"),
    ("conv_w", 2): (None, "embed"),
    ("lm_head", 2): ("embed", "vocab"),
    ("value_head", 2): ("embed", None),
    ("fc_w", 2): ("embed", "ffn"),
}


def _group(cand: Tuple[str, ...]):
    return cand if len(cand) > 1 else cand[0]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _trim(spec: list) -> P:
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


def resolve(logical, shape, mesh) -> P:
    """Greedy divisibility-aware assignment of mesh axes to dims."""
    sizes = axis_sizes(mesh)
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical):
        assigned = None
        for cand in MESH_MAP.get(name, ((),)):
            cand = tuple(a for a in cand if a in sizes)
            if not cand:
                continue
            total = 1
            for a in cand:
                total *= sizes[a]
            if any(a in used for a in cand):
                continue
            if dim % total == 0 and dim >= total:
                assigned = _group(cand)
                used.update(cand)
                break
        spec.append(assigned)
    return _trim(spec)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {a: d for d, entry in enumerate(spec) for a in _axes(entry)}
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def local_shape(shape, spec: P, mesh) -> tuple:
    """The per-rank shard shape of a tensor of ``shape`` under ``spec``
    (the rules shard only dims that divide)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


def leaf_name(name: str) -> str:
    """The rule key of a dotted parameter name: its last component."""
    return name.rsplit(".", 1)[-1]


def _leaf_logical(name: str, ndim: int):
    # norms, biases, scalars, per-head vectors: replicate
    return PARAM_RULES.get((leaf_name(name), ndim), (None,) * ndim)


def param_specs(params: dict, mesh) -> dict:
    """``{name: P}`` for a flat ``{name: tensor}`` dict (any tensor with a
    shape: meta, fake or real)."""
    return {n: resolve(_leaf_logical(n, len(p.shape)), tuple(p.shape), mesh)
            for n, p in params.items()}


def opt_state_specs(opt_state, pspecs: dict, mesh=None) -> Any:
    """Optimizer state mirrors params: any dict with the params' keys gets
    the param specs; other leaves (step counters) are replicated."""
    if isinstance(opt_state, dict):
        if set(opt_state) == set(pspecs):
            return dict(pspecs)
        return {k: opt_state_specs(v, pspecs, mesh)
                for k, v in opt_state.items()}
    if isinstance(opt_state, (tuple, list)):
        return type(opt_state)(opt_state_specs(v, pspecs, mesh)
                               for v in opt_state)
    return P()


def dg_state_specs(dg, pspecs: dict, mesh=None):
    """Specs for ``DelayedGradState(params, params_prev, opt_state,
    step)``."""
    from repro_torch.core.delayed_grad import DelayedGradState
    return DelayedGradState(
        params=pspecs, params_prev=pspecs,
        opt_state=opt_state_specs(dg.opt_state, pspecs, mesh), step=P())


# ------------------------------------------------------------ activations
def batch_pspec(mesh, batch_size: int):
    """The mesh axes to shard a batch dim over (or None to replicate)."""
    sizes = axis_sizes(mesh)
    for cand in MESH_MAP["batch"]:
        cand = tuple(a for a in cand if a in sizes)
        if not cand:
            continue
        total = 1
        for a in cand:
            total *= sizes[a]
        if batch_size % total == 0 and batch_size >= total:
            return _group(cand)
    return None


def batch_specs(batch: dict, mesh) -> dict:
    """Input batch dict: dim 0 is the batch (``mrope_positions`` (3, B, S):
    dim 1)."""
    out = {}
    for name, leaf in batch.items():
        nd = len(leaf.shape)
        if name == "mrope_positions":
            b = batch_pspec(mesh, leaf.shape[1])
            out[name] = P(None, b, *([None] * (nd - 2)))
        elif nd:
            out[name] = P(batch_pspec(mesh, leaf.shape[0]),
                          *([None] * (nd - 1)))
        else:
            out[name] = P()
    return out


def _kv_cache_spec(shape, mesh) -> P:
    """shape = (B, S, KV, Dh). Axes by priority: batch -> data/pod;
    kv_heads -> model; else seq -> model; else head_dim -> model; the
    sequence dim takes any axes left."""
    sizes = axis_sizes(mesh)
    B, S, KV, Dh = shape
    used: set = set()
    spec = [None, None, None, None]
    b = batch_pspec(mesh, B)
    if b is not None:
        spec[0] = b
        used.update(_axes(b))
    if "model" in sizes and "model" not in used:
        if KV % sizes["model"] == 0:
            spec[2] = "model"
            used.add("model")
        elif S % sizes["model"] == 0:
            spec[1] = "model"
            used.add("model")
        elif Dh % sizes["model"] == 0:
            spec[3] = "model"
            used.add("model")
    if spec[1] is None:
        rem = [a for a in sizes if a not in used and S % sizes[a] == 0]
        if rem:
            spec[1] = tuple(rem) if len(rem) > 1 else rem[0]
    elif spec[1] == "model":
        rem = [a for a in sizes if a not in used and
               (S // sizes["model"]) % sizes[a] == 0]
        if rem:
            spec[1] = tuple(["model"] + rem)
    return _trim(spec)


_CACHE_LOGICAL = {
    "state": ("batch", "heads", None, None),    # rwkv (B, H, N, N)
    "h": ("batch", "dsq"),                      # rglru (B, D)
    "conv": ("batch", None, "dsq"),             # (B, W-1, D)
    "xprev": ("batch", None, "dsq"),            # (B, 1, D)
}


def cache_specs(cache: list, cfg=None, mesh=None) -> list:
    """Per-layer decode caches: k/v by ``_kv_cache_spec``; the recurrent
    states shard batch over data and heads/channels over model."""
    def one(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            return _kv_cache_spec(shape, mesh)
        logical = _CACHE_LOGICAL.get(
            name, ("batch",) + (None,) * (len(shape) - 1))
        return resolve(logical, shape, mesh)

    return [{n: one(n, t) for n, t in layer.items()} for layer in cache]


def map_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree and its spec tree (a ``P`` is a
    leaf of the spec tree, not a tuple to descend into)."""
    if isinstance(spec_tree, P):
        return fn(tree, spec_tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, t, s)
                            for t, s in zip(tree, spec_tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, t, s)
                          for t, s in zip(tree, spec_tree))
    if tree is None:
        return None
    raise TypeError(f"no spec for a leaf of type {type(tree).__name__}")
