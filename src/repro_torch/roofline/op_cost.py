"""Per-rank cost of eager work, op by op: the counterpart of
``repro/roofline/hlo_cost.py``, which walks compiled HLO. Eager PyTorch
has no HLO, so ``OpCost`` is a ``TorchDispatchMode`` that sees each ATen
op a rank runs (under ``DTensor``, the local ops and collectives it
desugars into) and accumulates:

  * flops: matmul-class ops by ``torch.utils.flop_counter``'s formulas
    (2 per multiply-add), and each hand-written kernel by the count its
    binding reports (``kernels.notify``): flash attention's dense
    ``4·B·H·Sq·Sk·Dh`` forward and ``10·B·H·Sq·Sk·Dh`` backward, wkv6's
    ``7·B·T·H·N²`` and ``17·B·T·H·N²``, lru_scan's ``2·B·S·D`` and
    ``3·B·S·D``; a ctypes launch is invisible to a dispatch mode;
  * bytes: operand plus output bytes of every op that moves data (views
    and allocations excluded), the reference's upper-bound traffic proxy;
  * transcendentals: output elements of exp/log/tanh/sqrt/... ops;
  * collective bytes by op from the ``_c10d_functional`` ops, all-reduce
    counted twice as the reference counts it, split by link: the
    ``model`` mesh axis over NVLink, the others over InfiniBand;
  * with ``track_memory``, the live bytes of every tensor storage the ops
    make (and of those ``track`` registers), rounded to the caching
    allocator's 512-byte blocks, and their peak.

DTensor works out each op's output shape by running the op on fake
tensors of the global shape (its sharding propagation); those shadow ops
are no rank's work and are not counted: while the counter is active,
``ShardingPropagator``'s tensor-meta methods run with counting paused.

The reference's ``upcast_f32_bytes`` (XLA:CPU's f32 stash of bf16
buffers) has no counterpart: fake and eager tensors keep bf16.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import kernels

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "rsqrt", "sqrt", "pow", "sigmoid", "sin", "cos", "erf", "erfinv",
    "_softmax", "_log_softmax", "gelu", "silu", "softplus", "logit",
}

# ops that move no data: allocations and metadata
_NO_TRAFFIC = {
    "empty", "empty_like", "empty_strided", "_local_scalar_dense",
    "detach", "lift_fresh", "_to_copy_meta", "wait_tensor",
}

_BLOCK = 512          # the CUDA caching allocator's rounding
# > 0 while DTensor propagates shapes on global-shape fake tensors
_SHADOW = [0]
_META_METHODS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


def _shadowed(orig):
    def run(*args, **kwargs):
        _SHADOW[0] += 1
        try:
            return orig(*args, **kwargs)
        finally:
            _SHADOW[0] -= 1
    return run


@contextlib.contextmanager
def _shadow_ops_uncounted():
    """Pause counting inside DTensor's shape propagation."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    saved = {n: ShardingPropagator.__dict__[n] for n in _META_METHODS
             if n in ShardingPropagator.__dict__}
    for name, orig in saved.items():
        setattr(ShardingPropagator, name, _shadowed(orig))
    try:
        yield
    finally:
        for name, orig in saved.items():
            setattr(ShardingPropagator, name, orig)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class OpCost(TorchDispatchMode):
    """Accumulates one rank's costs while active. ``mesh`` names the
    collectives' axes (None: every collective counts as NVLink)."""

    def __init__(self, mesh=None, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.collective_bytes = defaultdict(float)
        self.collective_count = defaultdict(int)
        self.link_bytes = defaultdict(float)      # "nvlink" / "ib"
        self.kernel_calls = defaultdict(int)
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = WeakIdKeyDictionary()
        self._links = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                group = mesh.get_group(i)
                self._links[group.group_name] = (
                    "nvlink" if name == "model" else "ib")

    # --------------------------------------------------------- memory
    def track(self, tree) -> None:
        """Count the storages of the tensors in ``tree`` (a ``DTensor``
        by its local shard) as live."""
        for t in _tensors(tree):
            self._track(getattr(t, "_local_tensor", t))

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return      # no memory (a weightless skeleton's parameters)
        st = t.untyped_storage()
        if st in self._live:
            return
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._live[st] = n
        weakref.finalize(st, self._free, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -------------------------------------------------------- kernels
    def _kernel(self, name, inputs, outputs, flops, transcendentals):
        self.kernel_calls[name] += 1
        self.flops += flops
        self.transcendentals += transcendentals
        self.bytes += sum(_nbytes(t) for t in (*inputs, *outputs))

    def __enter__(self):
        kernels.LISTENERS.append(self._kernel)
        self._uncounted = _shadow_ops_uncounted()
        self._uncounted.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.LISTENERS.remove(self._kernel)
        self._uncounted.__exit__(*exc)
        return super().__exit__(*exc)

    # ------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar into local ops and collectives first
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _SHADOW[0]:
            return out
        self._count(func, args, kwargs, out)
        # a wait returns its input on the card (a fake one a new tensor)
        if self.track_memory and func._overloadpacket.__name__ not in \
                _NO_TRAFFIC:
            for t in _tensors(out):
                self._track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            b = sum(_nbytes(t) for t in _tensors(out))
            b *= 2 if op == "all-reduce" else 1
            self.collective_bytes[op] += b
            self.collective_count[op] += 1
            group = args[-1] if args else kwargs.get("group_name")
            self.link_bytes[self._links.get(group, "nvlink")] += b
            return
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        if func.is_view or name in _NO_TRAFFIC:
            return
        self.bytes += sum(_nbytes(t) for t in _tensors(args))
        self.bytes += sum(_nbytes(t) for t in _tensors(kwargs))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))

    # -------------------------------------------------------- results
    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "bytes accessed": self.bytes,
            "transcendentals": self.transcendentals,
            "collectives": {
                "bytes_by_op": dict(self.collective_bytes),
                "count_by_op": dict(self.collective_count),
                "total": sum(self.collective_bytes.values()),
                "nvlink_bytes": self.link_bytes.get("nvlink", 0.0),
                "ib_bytes": self.link_bytes.get("ib", 0.0),
            },
            "kernel_calls": dict(self.kernel_calls),
            "peak_bytes": self.peak_bytes,
        }


def nbytes_of(tree) -> int:
    """Bytes of the tensors in ``tree`` (a ``DTensor`` by its local
    shard)."""
    return sum(_nbytes(getattr(t, "_local_tensor", t))
               for t in _tensors(tree))

