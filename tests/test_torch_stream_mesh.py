"""The ``stream`` runtime on a live device mesh, and the dropless MoE's
per-data-shard branch, with 2 gloo ranks on the CPU (one spawn,
``torch.multiprocessing``, ``file://`` init under ``tmp_path``).

* Reduced StarCoder2-3B and reduced RecurrentGemma-9B in fp32 (two
  families: GQA attention; RG-LRU with local attention) trained one step
  on a ``(data=2)`` mesh and on a ``(model=2)`` mesh equal the no-mesh
  run within 1e-5: params (whole, ``full_tensor``) and per-step losses.
  SGD, so that a gradient entry near zero cannot flip a whole-lr step
  (an Adam step is -lr·sign(g) at first).
* ``moe_impl="dropless"`` (reduced Granite, fp32) on ``(data=2)``: the
  tokens routed per data shard under ``local_map`` equal the unsharded
  result, and the aux loss each shard's averaged over the shards (the
  reference's ``pmean``), within 1e-5.
* With no mesh the runtime takes none of the mesh code (the other stream
  tests hold its bits).
"""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch
import torch.multiprocessing as mp

TIMEOUT = 240
TOL = 1e-5
ARCHS = ("starcoder2-3b", "recurrentgemma-9b")
MESHES = ("data", "model")
BATCH, SEQ, STEPS, LR = 2, 8, 1, 0.05


def _cfg(arch: str, **kw):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **kw)


def _run(arch: str, mesh):
    from repro_torch import optim
    from repro_torch.core.engine import HTSConfig
    from repro_torch.core.stream_runtime import StreamRuntime
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import backbone
    cfg = _cfg(arch)
    model = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    rt = StreamRuntime(lambda: TokenStream(cfg.vocab_size, BATCH, SEQ, 0),
                       dict(model.named_parameters()), optim.sgd(LR),
                       HTSConfig(), cfg, mesh=mesh, device="cpu")
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    out = rt.run(STEPS)
    whole = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
             .detach().clone() for k, v in out.params.items()}
    moved = max((whole[k] - init[k]).abs().max().item() for k in init)
    return {"params": whole, "loss": out.metrics["loss"], "moved": moved,
            "placed": type(next(iter(out.params.values()))).__name__}


def _dropless(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe, moe_dropless
    cfg = _cfg("granite-moe-1b-a400m", moe_impl="dropless")
    ffn = moe.MoE(cfg)
    ffn.init_weights(torch.Generator().manual_seed(1))
    x = torch.randn(4, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y0, _ = moe_dropless.apply_moe_dropless(ffn, x, cfg)
        # the reference's aux: each shard's, averaged over the shards
        # (``pmean``); the load-balance loss is not linear in the tokens
        aux0 = torch.stack([moe_dropless.apply_moe_dropless(ffn, half, cfg)[1]
                            for half in x.chunk(2)]).mean()
        xd = distribute_tensor(x, mesh, [Shard(0)])
        for name, p in list(ffn.named_parameters(recurse=False)):
            setattr(ffn, name, torch.nn.Parameter(
                distribute_tensor(p.data, mesh, [Replicate()])))
        with use_mesh(mesh):
            y, aux = moe_dropless.apply_moe_dropless(ffn, xd, cfg)
    return {"y0": y0, "aux0": aux0, "y": y.full_tensor(),
            "aux": aux.full_tensor(), "y_placements": str(y.placements)}


def _worker(rank: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=2)
    out = {}
    for arch in ARCHS:
        out[arch, None] = _run(arch, None)
        for name in MESHES:
            mesh = init_device_mesh("cpu", (2,), mesh_dim_names=(name,))
            out[arch, name] = _run(arch, mesh)
    out["dropless"] = _dropless(init_device_mesh("cpu", (2,),
                                                 mesh_dim_names=("data",)))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _spawn(fn, nprocs: int, *args) -> None:
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {TIMEOUT}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    _spawn(_worker, 2, str(tmp))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_runtime_on_a_mesh_equals_no_mesh(ranks, arch, mesh):
    for out in ranks:
        base, got = out[arch, None], out[arch, mesh]
        assert base["placed"] == "Tensor" and got["placed"] == "DTensor"
        assert set(got["params"]) == set(base["params"])
        worst = max((got["params"][k] - base["params"][k]).abs().max()
                    .item() for k in base["params"])
        assert worst <= TOL, (arch, mesh, worst)
        # the params moved: the comparison is not of the initial weights
        assert got["moved"] > 100 * TOL
        assert abs(got["loss"] - base["loss"]).max() <= TOL
    # both ranks hold the same whole params
    for k, p in ranks[0][arch, mesh]["params"].items():
        assert torch.equal(p, ranks[1][arch, mesh]["params"][k])


def test_dropless_per_data_shard_equals_unsharded(ranks):
    for out in ranks:
        d = out["dropless"]
        assert "Shard(dim=0)" in d["y_placements"]
        assert (d["y"] - d["y0"]).abs().max().item() <= TOL
        assert abs(d["aux"].item() - d["aux0"].item()) <= TOL
