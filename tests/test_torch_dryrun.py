"""The port's dry run (``repro_torch.launch.dryrun``) on a fake world, in
one subprocess (the dry run makes and destroys a fake process group; no
pytest worker may be left holding one):

* a reduced StarCoder2-3B on a fake 4x4 ``(data, model)`` world, one
  train (Adam), prefill and decode step each: every tensor a
  ``FakeTensor``, the params, optimizer state, batch and caches placed
  by the rules, the flash kernel on its fake route under ``local_map``;
* the per-rank params + optimizer bytes equal the sum of the rules'
  local shard sizes exactly;
* the collectives are counted by op;
* at world 1 (``--mesh host``), the dry run's FLOPs equal ``op_cost``'s
  count of a real step on the CPU through the kernel's route, both
  bindings stood in by their plain versions (which count the same dense
  4·B·H·Sq·Sk·Dh and 10·B·H·Sq·Sk·Dh the bindings report);
* ``grad_comm_bf16`` 1 and 0 are both reported;
* the CLI prints the reference's ``[OK]`` / ``[SKIP]`` lines.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import dataclasses, json, math, sys
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import delayed_grad, learner
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import backbone
    from repro_torch.optim import adam
    from repro_torch.roofline.op_cost import OpCost
    from repro_torch.sharding import rules

    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              n_layers=1)
    shapes = {"train": specs.ShapeSpec("t", 64, 8, "train"),
              "prefill": specs.ShapeSpec("p", 64, 8, "prefill"),
              "decode": specs.ShapeSpec("d", 64, 8, "decode")}
    out = {}
    for kind, shape in shapes.items():
        out[kind] = dryrun.lower_one(
            "starcoder2-3b", shape, "pod", "adam",
            overrides={"grad_comm_bf16": 0}, cfg=cfg, mesh_shape=(4, 4))
    out["pg0"] = out["train"]
    out["pg1"] = dryrun.lower_one(
        "starcoder2-3b", shapes["train"], "pod", "adam",
        overrides={"grad_comm_bf16": 1}, cfg=cfg, mesh_shape=(4, 4))
    out["host"] = dryrun.lower_one("starcoder2-3b", shapes["train"],
                                   "host", "adam", cfg=cfg)
    out["group_left"] = torch.distributed.is_initialized()

    # the rules' local shard sizes of the train state, by hand
    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (4, 4)
    params = {n: p.detach() for n, p in
              backbone.Backbone(cfg, device="meta").named_parameters()}
    dg = delayed_grad.init(params, adam(1e-4))
    specs_ = rules.dg_state_specs(dg, rules.param_specs(params, Mesh()))
    total = []
    rules.map_specs(lambda t, s: total.append(
        math.prod(rules.local_shape(t.shape, s, Mesh())) * t.element_size()),
        dg, specs_)
    out["rules_state_bytes"] = sum(total)

    # a real CPU step at world 1 through the kernel's route, both
    # bindings stood in by their plain versions (as
    # test_torch_kernel_grads does): the forward with its lse, whose two
    # products are the 4 B H Sq Sk Dh the binding reports, and the
    # backward kernel's plain version, whose five are its 10 (the plain
    # route's autograd would count other products)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    fa_ops.use_kernel_for = lambda x, use_kernel: use_kernel
    fa_ops.kernel.flash_attention = (
        lambda q, k, v, causal=True, window=0, cap=0.0, lse=False:
        (lambda o, l: (o, l) if lse else o)(*fa_ref.flash_attention_fwd_ref(
            q, k, v, causal=causal, window=window, cap=cap)))
    fa_ops.kernel.flash_attention_bwd = fa_ref.flash_attention_bwd_ref
    real = dataclasses.replace(cfg, use_pallas_attention=True)
    torch.manual_seed(0)
    model = backbone.init_params(real, torch.Generator().manual_seed(0),
                                 "cpu")
    p = dict(model.named_parameters())
    dgr = delayed_grad.init({k: v.detach() for k, v in p.items()},
                            adam(1e-4))
    B, S = 8, 64
    batch = {"tokens": torch.randint(0, real.vocab_size, (B, S),
                                     dtype=torch.int32),
             "actions": torch.randint(0, real.vocab_size, (B, S),
                                      dtype=torch.int32),
             "advantages": torch.randn(B, S), "returns": torch.randn(B, S),
             "behavior_logprob": torch.randn(B, S),
             "loss_mask": torch.ones(B, S)}
    with OpCost() as oc:
        learner.make_train_step(real, adam(1e-4))(dgr, batch)
    out["real_flops"] = oc.flops

    # the CLI: a [SKIP] with the reference's reason, and its artifact
    import contextlib, io, tempfile
    with tempfile.TemporaryDirectory() as d:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                dryrun.main(["--arch", "starcoder2-3b", "--shape",
                             "long_500k", "--out", d])
            except SystemExit as e:
                out["cli_rc"] = e.code
        out["cli"] = buf.getvalue()
        out["cli_artifact"] = json.load(open(
            f"{d}/starcoder2-3b__long_500k__pod.json"))
    print("RESULT " + json.dumps(out, default=float))
""")


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_on_a_fake_4x4_world(runs, kind):
    r = runs[kind]
    assert "error" not in r and r["chips"] == 16
    assert r["peak_bytes_per_chip"] > r["memory"]["state_bytes"] > 0
    assert r["fits_80g"] is True
    assert r["cost_loop_aware"]["flops"] > 0
    roof = r["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert roof["compute_s"] == pytest.approx(
        r["cost_loop_aware"]["flops"] / 989.4e12)
    if kind == "train":
        # the flash kernels' fake route in the one layer: the forward and
        # the checkpointed layer's recompute, then the backward kernel
        assert r["kernel_calls"] == {"flash_attention": 2,
                                     "flash_attention_bwd": 1}
    elif kind == "prefill":
        assert r["kernel_calls"] == {"flash_attention": 1}


def test_state_bytes_are_the_rules_local_shards(runs):
    assert runs["train"]["memory"]["state_bytes"] == \
        runs["rules_state_bytes"]


def test_collectives_are_counted_by_op(runs):
    coll = runs["train"]["collectives"]
    assert set(coll["count_by_op"]) <= {"all-gather", "all-reduce",
                                        "reduce-scatter", "all-to-all",
                                        "broadcast"}
    assert coll["count_by_op"].get("all-gather", 0) > 0
    assert coll["total"] == pytest.approx(sum(coll["bytes_by_op"].values()))
    assert coll["nvlink_bytes"] + coll["ib_bytes"] == \
        pytest.approx(coll["total"])
    assert coll["nvlink_bytes"] > 0 and coll["ib_bytes"] > 0


def test_world_one_flops_equal_a_real_cpu_step(runs):
    host = runs["host"]
    assert host["chips"] == 1 and host["collectives"]["total"] == 0
    assert host["cost_loop_aware"]["flops"] == runs["real_flops"]


def test_grad_comm_bf16_both_reported(runs):
    for pg in ("pg0", "pg1"):
        assert runs[pg]["overrides"] == {"grad_comm_bf16": int(pg[-1])}
        assert runs[pg]["collectives"]["bytes_by_op"]
        assert runs[pg]["cost_loop_aware"]["flops"] > 0


def test_no_process_group_is_left(runs):
    assert runs["group_left"] is False


def test_cli_prints_skip_with_the_reference_reason(runs):
    assert runs["cli_rc"] == 0
    assert runs["cli"].startswith("[SKIP] starcoder2-3b long_500k pod")
    assert "full-attention architecture" in runs["cli"]
    assert runs["cli_artifact"]["skipped"]
