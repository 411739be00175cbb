"""The port's declarative surface against the JAX package's.

* Every ``examples/specs/*.json`` (those whose runtime or env the port
  cannot build yet included) parses to the reference's canonical JSON
  and ``workload_fingerprint``, byte for byte.
* Bad specs raise the same exception class in both packages, at spec
  time (validation) and at build time (registry names, kwargs, a
  device-port env named as the workload).
* ``launch/run.py --print-spec`` prints the reference's text;
  ``python -m repro_torch.launch.run --device cpu --spec quickstart
  --intervals 4`` prints the rewards ``api.build(...).run(4)`` gives; a
  checkpointed launcher run stopped at 4 and resumed to 6 equals
  ``Session.fit(6)`` bit for bit.
* What the port lacks raises ``NotImplementedError`` naming its ROADMAP
  item: the football env, the stream runtime's TPU meshes, the MoE and
  encoder-decoder backbones; ``Session.serve`` and ``Session.pool``
  work; the host,
  sync and async runtimes build and run. Without CUDA, ``build`` and the
  launcher raise unless ``cpu`` is asked for.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.launch import run as jrun  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import determinism  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPECS = sorted((ROOT / "examples" / "specs").glob("*.json"))
QUICKSTART = str(ROOT / "examples" / "specs" / "quickstart.json")


@pytest.mark.parametrize("path", SPECS, ids=lambda p: p.name)
def test_spec_files_canonicalize_like_the_reference(path):
    spec, jspec = api.load(str(path)), japi.load(str(path))
    assert api.dumps(spec, indent=2) == japi.dumps(jspec, indent=2)
    assert api.dumps(spec) == japi.dumps(jspec)
    fp = json.dumps(api.workload_fingerprint(spec), sort_keys=True)
    assert fp == json.dumps(japi.workload_fingerprint(jspec), sort_keys=True)
    assert api.loads(api.dumps(spec)) == spec
    assert path.read_text() == api.dumps(spec, indent=2) + "\n"


BAD_SPECS = [
    {"env": "catch", "hts": {"staleness": 0}},
    {"env": "catch", "hts": {"alpha": 0}},
    {"env": "catch", "hts": {"n_envs": 0}},
    {"env": "catch", "hts": {"algorithm": "ppo"}},
    {"env": "catch", "hts": {"aplha": 4}},
    {"environment": "catch"},
    {"env": "catch", "hts": {"env_backend": "tpu"}},
    {"env": "football", "hts": {"env_backend": "device"}},
    {"env": {"name": "catch", "extra": 1}},
    {"env": {"kwargs": {}}},
    {"env": 3},
    {"checkpoint": {"every": -1}},
    {"checkpoint": {"often": 1}},
    {"intervals": -1},
    {"serve": {"max_batch": 0}},
    {"tenancy": {"weight": 0}},
    {"faults": {"events": [{"site": "disk", "interval": 1}]}},
    {"faults": {"max_restarts": -1}},
    {"batch": {"grad_accumulation": 3}, "hts": {"n_envs": 16}},
    {"batch": {"n_replicas": 0}},
]


def _error_class(fn):
    try:
        fn()
    except Exception as e:       # the class is what the test compares
        return type(e)
    return None


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda d: json.dumps(d))
def test_bad_specs_raise_the_reference_class(bad):
    want = _error_class(lambda: japi.from_dict(bad))
    assert want is not None
    assert _error_class(lambda: api.from_dict(bad)) is want


BAD_BUILDS = [
    dict(env="nope"), dict(policy="nope"), dict(optimizer="nope"),
    dict(runtime="nope"), dict(algorithm="nope"),
    dict(env={"name": "catch", "kwargs": {"size": 3}}),
    dict(policy={"name": "mlp", "kwargs": {"width": 3}}),
    dict(optimizer={"name": "rmsprop", "kwargs": {"rate": 3}}),
    dict(env="catch_device"), dict(env="gridmaze_device"),
]


@pytest.mark.parametrize("bad", BAD_BUILDS, ids=lambda d: json.dumps(d))
def test_bad_builds_raise_the_reference_class(bad):
    spec = {"env": "catch", **bad}
    want = _error_class(lambda: japi.build(japi.ExperimentSpec(**spec)))
    assert want in (KeyError, ValueError)
    got = _error_class(lambda: api.build(api.ExperimentSpec(**spec),
                                         device="cpu"))
    assert got is want


@pytest.mark.parametrize("argv", [
    ["--spec", QUICKSTART, "--print-spec"],
    ["--spec", QUICKSTART, "--set", "hts.staleness=2", "--intervals", "5",
     "--runtime", "host", "--print-spec"],
    ["--env", "gridmaze", "--set", "env.kwargs.scenario_seed=7",
     "--algorithm", "ppo", "--ckpt-dir", "d", "--print-spec"],
])
def test_print_spec_matches_the_reference(argv, capsys, monkeypatch):
    run.main(argv)
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
    jrun.main()
    assert mine == capsys.readouterr().out


def test_module_entry_point_gives_the_session_rewards():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run", "--device", "cpu",
         "--spec", QUICKSTART, "--intervals", "4", "--log-every", "1"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    r = api.build(api.load(QUICKSTART), device="cpu").run(4).rewards
    lines = out.stdout.splitlines()
    for j in range(4):
        assert f"interval {j:5d} reward/step {np.mean(r[j]):+.4f}" in lines
    assert (f"reward/step: first 1 intervals {r[:1].mean():+.4f} -> last 1 "
            f"{r[-1:].mean():+.4f}") in lines
    assert any(line.startswith("[mesh] 512 steps in ") for line in lines)


def test_launcher_resume_equals_session_fit(tmp_path, capsys):
    common = ["--device", "cpu", "--spec", QUICKSTART, "--ckpt-dir",
              str(tmp_path / "ck"), "--ckpt-every", "2"]
    run.main(common + ["--intervals", "4"])
    run.main(common + ["--intervals", "6", "--resume"])
    out = capsys.readouterr().out
    assert "[mesh] 6 intervals (4 resumed)" in out
    spec = api.load(QUICKSTART).replace(
        checkpoint={"dir": str(tmp_path / "ref"), "every": 2})
    report = api.build(spec, device="cpu").fit(6)
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import trainer
    path = ckpt_io.latest(str(tmp_path / "ck"))
    assert path.endswith("step_00000006")
    state = trainer.restore_capsule(path, report.state)
    for a, b in zip(tree_leaves(state), tree_leaves(report.state)):
        assert torch.equal(a, b)
    meta = ckpt_io.load_metadata(path)
    np.testing.assert_array_equal(meta["metrics"]["returns"],
                                  report.episode_returns)


def test_session_observers_and_describe():
    session = api.build(api.load(QUICKSTART), device="cpu")
    seen = []
    session.on_interval(seen.append)
    out = session.run(3)
    assert [m["interval"] for m in seen] == [0, 1, 2]
    np.testing.assert_array_equal(seen[2]["rewards"], out.rewards[2])
    state = session.state()
    session.run_from(state, 2)
    assert [m["interval"] for m in seen[3:]] == [3, 4]
    session.remove_observer(seen.append)
    session.run(1)
    assert len(seen) == 5
    assert api.loads(session.describe()) == session.spec


_LLM = dict(env={"name": "token_stream",
                 "kwargs": {"vocab": 512, "batch": 2, "seq": 4}},
            runtime="stream")


def _backbone(**overrides):
    return {"name": "backbone", "kwargs": {"arch": "starcoder2-3b",
                                           "reduced": True, **overrides}}


@pytest.mark.parametrize("change,item", [
    (dict(_LLM, policy=_backbone(),
          runtime={"name": "stream", "kwargs": {"mesh": "pod"}}), "item 9"),
    (dict(env="football"), "item 8"),
    (dict(_LLM, policy=_backbone(ffn_cycle=["moe"])), "item 7b"),
    (dict(_LLM, policy=_backbone(is_encoder_decoder=True)), "item 7b"),
])
def test_unported_parts_raise_not_implemented(change, item):
    spec = api.ExperimentSpec(**{"env": "catch", **change})
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        api.build(spec, device="cpu")


@pytest.mark.parametrize("runtime", ["host", "sync", "async"])
def test_host_and_baseline_runtimes_build_and_run(runtime, capsys):
    """The runtimes of ROADMAP queue 1, item 4 build from a spec and run
    (the quickstart spec with 2 intervals), and the launcher's
    ``--runtime`` selects them."""
    spec = api.load(QUICKSTART).replace(runtime=runtime, intervals=2)
    session = api.build(spec, device="cpu")
    assert session.runtime.name == runtime
    out = session.run()
    assert out.rewards.shape == (2, 8, 16) and out.steps == 2 * 8 * 16
    run.main(["--device", "cpu", "--spec", QUICKSTART, "--runtime",
              runtime, "--intervals", "2"])
    assert f"[{runtime}] 256 steps" in capsys.readouterr().out


def test_serve_and_pool_raise_not_implemented():
    """ROADMAP queue 1, item 6 is ported: ``Session.serve`` answers
    requests and ``Session.pool`` builds a pool where both raised; the
    runtime names still equal the reference's."""
    from repro_torch.serve import ActionResult, PolicyServer
    from repro_torch.tenancy import TenantPool
    session = api.build(api.load(QUICKSTART), device="cpu")
    srv = session.serve()
    try:
        assert isinstance(srv, PolicyServer)
        obs = session.env.reset(determinism.master_key(0))[1]
        assert isinstance(srv.act(obs, seed=1, timeout=30), ActionResult)
    finally:
        srv.stop()
    pool = api.Session.pool([session.spec], device="cpu")
    assert isinstance(pool, TenantPool) and pool.tenants() == ["t0"]
    assert set(japi.runtime_names()) == set(api.runtime_names())


def test_no_cuda_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.build(api.load(QUICKSTART))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--spec", QUICKSTART, "--intervals", "1"])
