"""The data-parallel runtime (``core/sharded_runtime.py``,
``core/distributed.py``, ``launch/distributed.py``).

* In one process (no process group) ``sharded`` equals ``mesh`` with
  ``torch.equal``, at K 1 and 2, and through ``api.build``.
* Two processes (``torch.multiprocessing``, gloo, ``file://`` init under
  ``tmp_path``) at R=2, grad_accumulation 1 and 2, K 1 and 2: every
  rank's params, streams and gathered capsule equal the port's
  1-process mesh run bit for bit, and a capsule crosses replica counts
  both ways (mesh -> R=2, R=2 -> mesh). The same runs, started from a
  live JAX policy's params, hold their streams exactly and their params
  within 1e-5 against JAX's ``mesh`` runtime (the JAX 2-process test is
  flaky, so the port's 1-process run is the bit-exact oracle).
* ``python -m repro_torch.launch.distributed`` as two processes on a
  free TCP port prints the 1-process mesh run's digest on both.
* Validation errors match the reference's messages.

Every subprocess has a timeout; a hung rank is killed, not waited for.
"""
import faulthandler
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

jax = pytest.importorskip("jax")

from repro import models as jmodels  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import api, bridge, envs, models, optim  # noqa: E402
from repro_torch.core import determinism, distributed, engine  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.distributed import params_digest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
INTERVALS = 5
CFG = dict(alpha=4, n_envs=8, seed=3)
PARAMS_TOL = 1e-5
TIMEOUT = 240
# (staleness, grad_accumulation) cells of the 2-process run
CELLS = [(1, 1), (1, 2), (2, 1), (2, 2)]


@pytest.fixture(autouse=True)
def watchdog():
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _jparams():
    return jmodels.get_policy("mlp", jcatch.make()).init(jax.random.key(0))


def make(name, staleness=1, params=None, **kw):
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    if params is None:
        params = pol.init(determinism.master_key(0))
    cfg = engine.HTSConfig(**CFG, staleness=staleness)
    return engine.make_runtime(name, env1, pol.apply, params,
                               optim.rmsprop(7e-4, eps=1e-5), cfg,
                               device="cpu", **kw)


def assert_same(a, b):
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    np.testing.assert_array_equal(a.rewards, b.rewards)
    np.testing.assert_array_equal(a.dones, b.dones)


def assert_same_tail(cont, straight):
    """A continuation's params and streams against the straight run's
    (the streams' tail)."""
    n = cont.rewards.shape[0]
    assert all(torch.equal(cont.params[k], straight.params[k])
               for k in straight.params)
    np.testing.assert_array_equal(cont.rewards, straight.rewards[-n:])
    np.testing.assert_array_equal(cont.dones, straight.dones[-n:])


def _capsules_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ------------------------------------------------------------ 1 process
@pytest.mark.parametrize("staleness", [1, 2])
def test_sharded_without_group_equals_mesh(staleness):
    rt = make("sharded", staleness)
    assert rt.n_shards == 1 and rt.group is None
    assert rt.geometry.n_replicas == 1
    assert_same(rt.run(INTERVALS), make("mesh", staleness).run(INTERVALS))
    m = make("mesh", staleness)
    m.run(INTERVALS)
    assert _capsules_equal(rt.state(), m.state())


def test_sharded_spec_builds_and_equals_mesh():
    spec = api.load(str(ROOT / "examples/specs/quickstart.json")).replace(
        intervals=3)
    out = api.build(spec.replace(runtime="sharded"), device="cpu").run()
    assert_same(out, api.build(spec, device="cpu").run())
    assert out.rewards.shape == (3, 8, 16)


def test_sharded_capsule_continues_on_mesh_in_one_process():
    rt = make("sharded", 2)
    rt.run(2)
    assert_same_tail(make("mesh", 2).run_from(rt.state(), 3),
                     make("mesh", 2).run(5))


# ------------------------------------------------------------ validation
def test_validation_messages():
    with pytest.raises(ValueError, match="n_replicas=2 but only 1"):
        make("sharded", batch={"n_replicas": 2})
    with pytest.raises(ValueError, match="staleness"):
        make("sharded", 0)
    with pytest.raises(ValueError, match="bad process topology"):
        distributed.initialize("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        distributed.global_data_group()
    assert distributed.default_backend("cpu", 2) == "gloo"
    with pytest.raises(ValueError, match="runs on CUDA devices"):
        distributed.initialize("127.0.0.1:1", 1, 0, backend="nccl",
                               device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.initialize("127.0.0.1:1", 1, 0, backend="mpi",
                               device="cpu")
    assert not distributed.is_initialized()


def test_spec_runtime_sharded_reaches_the_port():
    spec = api.ExperimentSpec(runtime="sharded", hts={"n_envs": 8})
    session = api.build(spec, device="cpu")
    assert session.runtime.name == "sharded"
    with pytest.raises(ValueError, match="n_replicas=2 but only 1"):
        api.build(spec.replace(batch={"n_replicas": 2}), device="cpu")


# ----------------------------------------------------------- 2 processes
def _worker(rank: int, tmp: str) -> None:
    """One rank of the 2-process runs; results to ``tmp/rank<r>.pt``."""
    backend = distributed.initialize(f"file://{tmp}/init", 2, rank,
                                     device="cpu")
    jparams = torch.load(f"{tmp}/jax_params.pt", weights_only=False)
    capsule = torch.load(f"{tmp}/mesh_capsule.pt", weights_only=False)
    out = {"backend": backend}
    for K, A in CELLS:
        rt = make("sharded", K, batch={"n_replicas": 2,
                                       "grad_accumulation": A})
        r = rt.run(INTERVALS)
        out[(K, A)] = {"params": r.params, "rewards": r.rewards,
                       "dones": r.dones, "state": rt.state(),
                       "geometry": rt.geometry.canonical()}
    out["jax"] = make("sharded", 2, params=jparams).run(INTERVALS).params
    rt = make("sharded", 2)
    out["from_mesh"] = rt.run_from(capsule, INTERVALS - 2).params
    rt.run(2)
    out["capsule"] = rt.state()
    errors = {}
    for what, call in (
            ("mismatch", lambda: make("sharded",
                                      batch={"n_replicas": 3})),
            ("group", lambda: distributed.global_data_group(3))):
        try:
            call()
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


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
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    jp = bridge.policy_params_from_jax(jax.tree.map(np.asarray, _jparams()))
    torch.save(jp, tmp / "jax_params.pt")
    m = make("mesh", 2)
    m.run(2)
    torch.save(m.state(), tmp / "mesh_capsule.pt")
    _spawn(_worker, 2, str(tmp))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("staleness,grad_accumulation", CELLS)
def test_two_processes_equal_one_process_mesh(two_ranks, staleness,
                                              grad_accumulation):
    mesh = make("mesh", staleness)
    want = mesh.run(INTERVALS)
    for rank in two_ranks:
        assert rank["backend"] == "gloo"
        got = rank[(staleness, grad_accumulation)]
        assert got["geometry"] == {"micro_batch": 4 // grad_accumulation,
                                   "grad_accumulation": grad_accumulation,
                                   "n_replicas": 2, "global_batch": 8}
        assert all(torch.equal(got["params"][k], want.params[k])
                   for k in want.params)
        np.testing.assert_array_equal(got["rewards"], want.rewards)
        np.testing.assert_array_equal(got["dones"], want.dones)
        assert _capsules_equal(got["state"], mesh.state())


def test_two_processes_capsules_cross_replica_counts(two_ranks):
    straight = make("mesh", 2).run(INTERVALS)
    for rank in two_ranks:
        assert all(torch.equal(rank["from_mesh"][k], straight.params[k])
                   for k in straight.params)
    for rank in two_ranks:
        back = make("mesh", 2).run_from(rank["capsule"], INTERVALS - 2)
        assert_same_tail(back, straight)


def test_two_processes_against_live_jax(two_ranks):
    env1 = jcatch.make()
    pol = jmodels.get_policy("mlp", env1)
    jout = jengine.make_runtime(
        "mesh", env1, pol.apply, _jparams(), jrmsprop(7e-4, eps=1e-5),
        jengine.HTSConfig(**CFG, staleness=2)).run(INTERVALS)
    port = make("mesh", 2, params=bridge.policy_params_from_jax(
        jax.tree.map(np.asarray, _jparams()))).run(INTERVALS)
    np.testing.assert_array_equal(port.rewards, jout.rewards)
    np.testing.assert_array_equal(port.dones, jout.dones)
    for rank in two_ranks:
        for k, v in jout.params.items():
            assert torch.equal(rank["jax"][k], port.params[k]), k
            diff = np.abs(rank["jax"][k].numpy() - np.asarray(v)).max()
            assert diff <= PARAMS_TOL, (k, diff)


def test_two_processes_validation_messages(two_ranks):
    for rank in two_ranks:
        assert "batch.n_replicas=3 != the 2-rank process group" in \
            rank["errors"]["mismatch"]
        assert "batch.n_replicas=3 != 2 global rank(s)" in \
            rank["errors"]["group"]


# ------------------------------------------------------------------ CLI
def test_launcher_two_processes_print_the_mesh_digest(tmp_path):
    spec = api.ExperimentSpec(
        runtime="sharded", hts={"alpha": 5, "n_envs": 4, "seed": 3},
        optimizer={"name": "rmsprop", "kwargs": {"lr": 7e-4,
                                                 "eps": 1e-5}},
        intervals=3, batch={"n_replicas": 2})
    path = tmp_path / "spec.json"
    api.save(spec, str(path))
    # the port stays bound from the probe to the store: process 0 serves
    # the store on this very socket (distributed.STORE_FD_ENV), so no
    # other process can take the port in between
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed",
         "--spec", str(path), "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(i), "--device", "cpu"],
        env=dict(env, **({distributed.STORE_FD_ENV: str(sock.fileno())} if i == 0
                         else {})),
        pass_fds=(sock.fileno(),) if i == 0 else (),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        sock.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    lines = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [x["process"] for x in lines] == [0, 1]
    assert all(x["backend"] == "gloo" and x["gather"] == "device"
               and x["devices"] == 2 for x in lines)
    mesh = api.build(spec.replace(runtime="mesh", batch=None),
                     device="cpu").run(3)
    assert {x["params_sha256"] for x in lines} == {params_digest(mesh.params)}
