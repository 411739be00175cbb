"""Dry run on the production meshes: one train, prefill or decode step of
every (architecture x input shape) on a fake 256- or 512-rank world,
the per-rank memory peak, FLOPs, bytes and collectives, and the roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
step for 512 placeholder devices. Here the world is a fake process group
(``torch.testing``'s ``FakeStore`` and ``"fake"`` backend: every
collective returns at once) and every tensor a ``FakeTensor`` on
``cuda`` (shapes, dtypes and strides, no storage), so the step runs
eagerly on one CPU process as rank 0 would run it. The params,
``params_prev``, the optimizer state, the batch and the caches are
``DTensor``s placed by ``sharding.rules``; the step runs under
``use_mesh`` (``constrain``) and ``implicit_replication``, with
``cfg.use_pallas_attention=True`` as the launchers run it, so each
kernel takes its fake route (the binding allocates its outputs and
launches nothing) under ``local_map``. ``roofline.op_cost.OpCost``
counts the rank's FLOPs, bytes, collectives and live memory.

The fake group is made and destroyed inside ``lower_one``, which sets
nothing at import. ``--mesh host`` is the same dry run at world 1, with
plain (unsharded) fake tensors and no process group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, list_configs
from repro_torch.core import delayed_grad, learner
from repro_torch.core.tree import tree_map
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import (HBM_BYTES, MULTIPOD_AXES,
                                     MULTIPOD_SHAPE, POD_SHAPE,
                                     make_production_mesh, use_mesh)
from repro_torch.models import backbone
from repro_torch.optim import adam, rmsprop
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import OpCost, nbytes_of
from repro_torch.sharding import rules

ARCH_SKIP_LIST = ()
# the fake tensors' and the mesh's device: ``cuda`` where torch is built
# with it (the autograd engine needs a device guard for the device its
# leaves name; a CPU-only build has none for cuda), else ``cpu``; either
# way each kernel takes its fake route (``kernels.use_kernel_for``). On a
# ``cpu`` mesh DTensor moves a shard to another dim by all-gather and
# chunk (its gloo fallback) where a ``cuda`` mesh does an all-to-all:
# those bytes then count as all-gather
DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"
MESHES = {"pod": POD_SHAPE, "multipod": MULTIPOD_SHAPE, "host": (1,)}


@contextlib.contextmanager
def fake_world(mesh_name: str, mesh_shape=None):
    """The mesh of ``mesh_name`` over a fake process group of its rank
    count, destroyed on exit; ``host``: no group, no mesh (``None``).
    ``mesh_shape`` (tests: a small world) replaces the production shape,
    its axes ``("data", "model")`` or ``("pod", "data", "model")``."""
    if mesh_name == "host" and mesh_shape is None:
        yield None
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already initialized in this process")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = tuple(mesh_shape or MESHES[mesh_name])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        if mesh_shape is None:
            yield make_production_mesh(
                multi_pod=(mesh_name == "multipod"), device_type=DEVICE)
        else:
            yield init_device_mesh(DEVICE, shape,
                                   mesh_dim_names=MULTIPOD_AXES[-len(shape):])
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _index_math_off_fake():
    """DTensor works out a strided shard's offsets (a reshape that merges
    a sharded inner dim, e.g. (B, S) with S split) with ``torch.arange``
    and ``.tolist()``; under ``FakeTensorMode`` that arange is a fake
    tensor with no values. Run that computation with the fake mode unset:
    it reads sizes only, never a model tensor."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    orig = None if cls is None else cls.__dict__.get(
        "local_shard_size_and_offset")
    if orig is None:
        yield
        return

    def patched(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = patched
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _typed(cfg, overrides: dict):
    typed = {}
    for k, v in (overrides or {}).items():
        cur = getattr(cfg, k)
        typed[k] = type(cur)(int(v) if not isinstance(cur, str) else v)
    return dataclasses.replace(cfg, **typed)


def _place(meta, spec, mesh):
    """A fake tensor of ``meta``'s shape and dtype on ``DEVICE``, as a
    ``DTensor`` placed by ``spec``."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(rules.local_shape(meta.shape, spec, mesh),
                        dtype=meta.dtype, device=DEVICE)
    return DTensor.from_local(local, mesh, rules.to_placements(spec, mesh),
                              run_check=False, shape=meta.shape,
                              stride=torch.empty(meta.shape,
                                                 device="meta").stride())


def _fake(tree, mesh, specs_of):
    """``tree``'s leaves as fake tensors on ``DEVICE``; on a mesh,
    ``DTensor``s placed by the specs ``specs_of(tree)``."""
    if mesh is None:
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=DEVICE), tree)
    return rules.map_specs(lambda t, s: _place(t, s, mesh), tree,
                           specs_of(tree))


def _opt(name: str):
    return rmsprop(7e-4, eps=1e-5) if name == "rmsprop" else adam(1e-4)


def _run_step(cfg, shape, mesh, opt_name: str, micro: int):
    """The step of ``shape`` on fake placed inputs under an ``OpCost``.
    Returns (the counter, the per-rank bytes of the step's persistent
    inputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    params_meta = {n: p.detach() for n, p in
                   backbone.Backbone(cfg, device="meta").named_parameters()}
    opt = _opt(opt_name)
    dg_meta = delayed_grad.init(params_meta, opt)

    def param_specs(t):
        return rules.param_specs(t, mesh)

    def batch_specs(t):
        return rules.batch_specs(t, mesh)

    def cache_specs(t):
        return rules.cache_specs(t, cfg, mesh)

    oc = OpCost(mesh, track_memory=True)
    with FakeTensorMode(), _index_math_off_fake(), use_mesh(mesh), \
            (implicit_replication() if mesh is not None
             else contextlib.nullcontext()):
        if shape.kind == "train":
            dg = _fake(dg_meta, mesh, lambda t: rules.dg_state_specs(
                t, param_specs(params_meta)))
            batch = _fake(specs_mod.train_batch_specs(cfg, shape), mesh,
                          batch_specs)
            state = nbytes_of(dg)
            step = learner.make_train_step(cfg, opt, n_microbatches=micro)
            oc.track((dg, batch))
            with oc:
                step(dg, batch)
        elif shape.kind == "prefill":
            params = _fake(params_meta, mesh, param_specs)
            batch = _fake(specs_mod.prefill_batch_specs(cfg, shape), mesh,
                          batch_specs)
            cache = _fake(backbone.init_decode_cache(
                cfg, shape.global_batch, shape.seq_len, device="meta"),
                mesh, cache_specs)
            state = nbytes_of(params)
            step = learner.make_prefill_step(cfg, shape.seq_len)
            oc.track((params, batch, cache))
            with oc, torch.no_grad():
                step(params, batch, cache=cache)
        else:
            params = _fake(params_meta, mesh, param_specs)
            token, cache, _, extras = specs_mod.decode_specs(cfg, shape)
            cache = _fake(cache, mesh, cache_specs)
            token = _fake({"tokens": token}, mesh, batch_specs)["tokens"]
            extras = _fake(extras, mesh, batch_specs)
            state = nbytes_of((params, cache))
            step = learner.make_serve_step(cfg)
            oc.track((params, cache, token, extras))
            with oc, torch.no_grad():
                model = backbone.from_params(cfg, params)
                step(model, token, cache, shape.seq_len - 1, extras)
    return oc, state


def lower_one(arch: str, shape_name, mesh_name: str,
              opt_name: str = "rmsprop", extra_tag: str = "",
              overrides: dict | None = None, micro: int = 1, *,
              cfg=None, mesh_shape=None):
    """One dry run. ``shape_name`` names a ``specs.SHAPES`` entry or is a
    ``specs.ShapeSpec``; ``cfg`` (a reduced config, in tests) replaces
    the registered one, ``mesh_shape`` the mesh's. Returns the artifact
    dict."""
    cfg = dataclasses.replace(_typed(cfg or get_config(arch), overrides),
                              use_pallas_attention=True)
    shape = (shape_name if isinstance(shape_name, specs_mod.ShapeSpec)
             else specs_mod.SHAPES[shape_name])
    reason = specs_mod.skip_reason(cfg, shape.name)
    if reason:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "skipped": reason}
    with fake_world(mesh_name, mesh_shape) as mesh:
        chips = 1 if mesh is None else mesh.size()
        t0 = time.time()
        oc, state = _run_step(cfg, shape, mesh, opt_name, micro)
        t_step = time.time() - t0
    cost = oc.summary()
    peak = float(oc.peak_bytes)
    mf = analysis.model_flops_for(cfg, shape.kind, shape.seq_len,
                                  shape.global_batch)
    la_cost = {k: cost[k] for k in ("flops", "bytes accessed",
                                     "transcendentals")}
    roof = analysis.build_roofline(arch, shape.name, mesh_name, chips,
                                   la_cost, cost["collectives"], mf, peak)
    roof.note = ("eager op-by-op count on fake tensors (op_cost); bytes "
                 "are an upper-bound traffic proxy (per-op operand+output)")
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "tag": extra_tag, "chips": chips,
        "overrides": dict(overrides or {}), "opt": opt_name,
        "step_s": round(t_step, 2),
        "memory": {"state_bytes": state, "peak_bytes": peak},
        "peak_bytes_per_chip": peak,
        "fits_80g": peak < HBM_BYTES,
        "cost_loop_aware": la_cost,
        "collectives": cost["collectives"],
        "kernel_calls": cost["kernel_calls"],
        "roofline": json.loads(roof.to_json()),
    }


def _line(res: dict) -> str:
    status = ("SKIP" if res.get("skipped")
              else "FAIL" if res.get("error") else "OK")
    extra = ""
    if status == "OK":
        coll = res["collectives"]["bytes_by_op"]
        extra = (f" peak/chip={res['peak_bytes_per_chip'] / 1e9:.2f}GB"
                 f" fits_80g={res['fits_80g']}"
                 f" bottleneck={res['roofline']['bottleneck']}"
                 f" collectives={{"
                 + ", ".join(f"{k}: {v / 1e9:.3f}GB"
                             for k, v in sorted(coll.items())) + "}")
    elif status == "SKIP":
        extra = f" {res['skipped']}"
    else:
        extra = f" {res['error']}"
    return (f"[{status}] {res['arch']} {res['shape']} {res['mesh']}"
            f" ({res['wall_s']}s){extra}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default="rmsprop", choices=["rmsprop", "adam"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. attn_tp_repeat=1")
    ap.add_argument("--micro", type=int, default=1,
                    help="gradient-accumulation microbatches (train)")
    ap.add_argument("--resume", action="store_true",
                    help="skip combos whose artifact already exists")
    args = ap.parse_args(argv)
    overrides = dict(o.split("=", 1) for o in args.override)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(specs_mod.SHAPES) if (args.all or not args.shape) \
        else [args.shape]

    failures = 0
    for arch in archs:
        for shape in shapes:
            tagpart = f"__{args.tag}" if args.tag else ""
            fname = outdir / f"{arch}__{shape}__{args.mesh}{tagpart}.json"
            if args.resume and fname.exists() and \
                    "error" not in fname.read_text()[:200]:
                print(f"[RESUME-SKIP] {arch} {shape} {args.mesh}",
                      flush=True)
                continue
            t0 = time.time()
            try:
                res = lower_one(arch, shape, args.mesh, args.opt,
                                args.tag, overrides, args.micro)
            except Exception as e:
                failures += 1
                res = {"arch": arch, "shape": shape, "mesh": args.mesh,
                       "error": f"{type(e).__name__}: {e}"[:2000],
                       "traceback": traceback.format_exc()[-4000:]}
            res["wall_s"] = round(time.time() - t0, 2)
            fname.write_text(json.dumps(res, indent=1, default=float))
            print(_line(res), flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
