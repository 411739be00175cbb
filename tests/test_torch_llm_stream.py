"""The ``stream`` runtime, ``api.build`` of an LLM spec and
``launch/train.py`` against live JAX, on the CPU.

One reference run serves the file: the JAX package's ``StreamRuntime``
as its ``launch.train --arch starcoder2-3b --reduced --batch 2 --seq 16``
builds it (bf16, adam 1e-4, a2c; the weights the port's ``init_params``
draws, carried over, where the reference's own draw would spend seconds
of eager JAX), run 2 intervals, its capsule saved as that launcher saves
it, then continued 3 more.

* The port's ``StreamRuntime`` on the same weights (bridged) gives the
  reference's per-interval losses, at bf16's 3e-2; ``run(a + b)`` is
  ``run(a)`` then ``run_from(state, b)`` bit for bit; the refusals
  (algorithm, staleness, meshes, workload pairings) are the reference's.
* ``api.build(examples/specs/llm_stream.json)``: observers receive every
  interval's loss stats, live; ``Session.fit`` checkpoints in the
  reference's treedef and resumes bit for bit.
* ``python -m repro_torch.launch.train`` (in process): stopped and
  resumed equals one straight run, every checkpoint leaf; a checkpoint
  whose metadata disagrees with the flags is refused; without CUDA and
  without ``--device cpu`` it raises. Cross-package: the port's launcher
  resumes the reference's checkpoint and continues with the reference's
  losses, and the reference restores the port's checkpoint (every check
  of its ``restore``) and continues with the losses of its own run.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.core import delayed_grad as jdg  # noqa: E402
from repro.core.engine import TrainState as JTrainState  # noqa: E402
from repro_torch import api, bridge  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core.engine import HTSConfig  # noqa: E402
from repro_torch.core.stream_runtime import StreamRuntime  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LLM_SPEC = ROOT / "examples" / "specs" / "llm_stream.json"
BATCH, SEQ, LR = 2, 16, 1e-4
LOSS_TOL = 3e-2          # bf16 (tests/test_kernels.py)
FIRST, REST = 2, 3


def _spec_dict():
    """The spec the reference's launch.train builds for
    ``--arch starcoder2-3b --reduced --batch 2 --seq 16``."""
    return dict(env={"name": "token_stream",
                     "kwargs": {"vocab": 512, "batch": BATCH, "seq": SEQ}},
                policy={"name": "backbone",
                        "kwargs": {"arch": "starcoder2-3b",
                                   "reduced": True}},
                optimizer={"name": "adam", "kwargs": {"lr": LR}},
                algorithm="a2c",
                runtime={"name": "stream", "kwargs": {"mesh": "host"}},
                intervals=FIRST + REST)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    from repro.configs.base import get_config as jget
    from repro.core.engine import HTSConfig as JHTSConfig
    from repro.core.stream_runtime import StreamRuntime as JStreamRuntime
    from repro.data.pipeline import TokenStream as JTokenStream
    from repro.optim import adam as jadam
    from repro_torch.configs.base import get_config
    from repro_torch.models import backbone
    cfg = get_config("starcoder2-3b").reduced()
    model = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params = jax.tree.map(
        lambda t: bridge.to_numpy(t.float()).astype(jax.numpy.bfloat16)
        if t.dtype == torch.bfloat16 else bridge.to_numpy(t),
        bridge.backbone_params_to_reference(dict(model.named_parameters()),
                                            cfg))
    session = JStreamRuntime(
        lambda: JTokenStream(512, BATCH, SEQ, 0),
        jax.tree.map(jax.numpy.asarray, params), jadam(lr=LR),
        JHTSConfig(), jget("starcoder2-3b").reduced())
    session.params, session.opt = session.params0, session.opt
    first = session.run(FIRST)
    state = session.state()
    d = tmp_path_factory.mktemp("jax_ckpt")
    # what repro.launch.train's save_ckpt writes
    jio.save(f"{d}/step_{FIRST:08d}", state.algo,
             {"arch": "starcoder2-3b", "step": FIRST, "algorithm": "a2c",
              "opt": "adam", "batch": BATCH, "seq": SEQ})
    rest = session.run_from(state, REST)
    losses = np.concatenate([first.metrics["loss"], rest.metrics["loss"]])
    return {"session": session, "ckpt_dir": d, "losses": losses,
            "params": params}


def _port_runtime(reference, **hts):
    from repro_torch.configs.base import get_config
    cfg = get_config("starcoder2-3b").reduced()
    from repro_torch import optim
    return StreamRuntime(
        lambda: TokenStream(cfg.vocab_size, BATCH, SEQ, 0),
        bridge.backbone_params_from_jax(reference["params"], cfg),
        optim.get_optimizer("adam", lr=LR), HTSConfig(**hts), cfg,
        device="cpu")


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_stream_runtime_matches_the_reference_losses(reference):
    rt = _port_runtime(reference)
    out = rt.run(FIRST + REST)
    np.testing.assert_allclose(out.metrics["loss"], reference["losses"],
                               rtol=0, atol=LOSS_TOL)
    assert int(out.state.step) == FIRST + REST
    assert out.steps == (FIRST + REST) * BATCH * SEQ
    assert out.rewards.shape == (FIRST + REST, 0, 0)


def test_run_equals_run_then_run_from(reference):
    rt = _port_runtime(reference)
    straight = rt.run(FIRST + REST)
    full = rt.state()
    rt.run(FIRST)
    mid = rt.state()
    assert int(mid.interval) == FIRST
    # the capsule is a host copy: running on does not touch it
    keep = [t.clone() for t in tree_leaves(mid)]
    out = rt.run_from(mid, REST)
    assert all(torch.equal(a, b) for a, b in zip(keep, tree_leaves(mid)))
    assert _equal(rt.state().algo, full.algo)
    np.testing.assert_array_equal(out.metrics["loss"],
                                  straight.metrics["loss"][FIRST:])


# the reference raises the first three only after its policy init, which
# costs seconds of eager JAX: their messages are checked against the port
@pytest.mark.parametrize("change,exc,match", [
    (dict(algorithm="vtrace"), ValueError, "implements \\['a2c', 'ppo'\\]"),
    (dict(hts={"staleness": 2}), ValueError, "delay-1 LLM learner"),
    (dict(runtime={"name": "stream", "kwargs": {"mesh": "multipod"}}),
     NotImplementedError, "ROADMAP queue 1, item 9"),
    (dict(runtime={"name": "stream", "kwargs": {"mesh": "ring"}}),
     ValueError, "unknown mesh name 'ring'"),
    (dict(env="catch"), ValueError, "consumes a TokenStream workload"),
    (dict(runtime="mesh"), ValueError, "pairs only with runtime 'stream'"),
    (dict(env={"name": "token_stream", "kwargs": {"vocab": 64, "batch": 2,
                                                  "seq": 4}}),
     ValueError, "vocab=64 != model vocab_size=512"),
    (dict(policy="mlp"), ValueError, "could not be sized to env"),
])
def test_refusals_are_the_reference(change, exc, match):
    spec = _spec_dict()
    spec.update(change)
    with pytest.raises(exc, match=match):
        api.build(api.ExperimentSpec(**spec), device="cpu")
    late = "algorithm" in change or "hts" in change or "vocab=" in match
    if exc is ValueError and not late:
        with pytest.raises(ValueError, match=match):
            japi.build(japi.ExperimentSpec(**spec))


def test_llm_spec_builds_observes_and_fits(reference, tmp_path):
    spec = api.load(str(LLM_SPEC))
    assert api.dumps(spec) == japi.dumps(japi.load(str(LLM_SPEC)))
    session = api.build(spec, device="cpu")
    assert isinstance(session.runtime, StreamRuntime)
    seen = []
    session.on_interval(seen.append)
    out = session.run(2)
    assert [m["interval"] for m in seen] == [0, 1]
    assert [m["loss"] for m in seen] == list(out.metrics["loss"])
    assert all(np.isfinite(m["entropy"]) for m in seen)
    # checkpointed fit: stopped at 2, resumed to 3, equals fit(3)
    def fitted(name):
        return api.build(spec.replace(checkpoint={
            "dir": str(tmp_path / name), "every": 1}), device="cpu")
    straight = fitted("b")
    straight.fit(3)
    fitted("a").fit(2)
    report = fitted("a").fit(3, resume=True)
    assert report.resumed_from == 2
    assert _equal(report.state.algo, straight.state().algo)
    manifest = json.loads((tmp_path / "a" / "step_00000003.json")
                          .read_text())
    # the reference runtime's spec is this file's
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(
        reference["session"].state()))


def _launch(argv, capsys):
    train.main(argv + ["--device", "cpu", "--log-every", "1"])
    return capsys.readouterr().out


def _losses(out: str) -> dict:
    return {int(line.split()[1]): float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("step ")}


LAUNCH = ["--arch", "starcoder2-3b", "--reduced", "--batch", str(BATCH),
          "--seq", str(SEQ)]


def test_launcher_resume_equals_a_straight_run(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    out = _launch(LAUNCH + ["--steps", "2", "--ckpt-dir", a,
                            "--ckpt-every", "1"], capsys)
    assert "checkpoint ->" in out and "params, 2 layers" in out
    out = _launch(LAUNCH + ["--steps", "3", "--ckpt-dir", a, "--resume"],
                  capsys)
    assert f"resuming from {a}/step_00000002 at step 2" in out
    _launch(LAUNCH + ["--steps", "3", "--ckpt-dir", b], capsys)
    got = np.load(f"{a}/step_00000003.npz")
    want = np.load(f"{b}/step_00000003.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    assert ckpt_io.load_metadata(f"{a}/step_00000003")["step"] == 3
    with pytest.raises(SystemExit, match="has batch=2, but this run was "
                                         "launched with 3"):
        train.main(["--arch", "starcoder2-3b", "--reduced", "--batch", "3",
                    "--seq", str(SEQ), "--steps", "4", "--ckpt-dir", a,
                    "--resume", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train.main(LAUNCH + ["--ckpt-every", "2", "--device", "cpu"])


def test_launcher_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(LAUNCH + ["--steps", "1"])


def test_port_resumes_the_reference_checkpoint(reference, capsys, tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    for f in reference["ckpt_dir"].iterdir():
        (d / f.name).write_bytes(f.read_bytes())
    out = _launch(LAUNCH + ["--steps", str(FIRST + REST), "--ckpt-dir",
                            str(d), "--resume"], capsys)
    assert f"at step {FIRST}" in out
    losses = _losses(out)
    assert sorted(losses) == list(range(FIRST, FIRST + REST))
    np.testing.assert_allclose([losses[i] for i in sorted(losses)],
                               reference["losses"][FIRST:], rtol=0,
                               atol=LOSS_TOL)


def test_reference_resumes_the_port_checkpoint(reference, capsys, tmp_path):
    """The port's launcher stops at 2 on its own weights; the reference
    continues from that checkpoint with the losses the port's own
    resumed run gives."""
    d = str(tmp_path / "ckpt")
    _launch(LAUNCH + ["--steps", str(FIRST), "--ckpt-dir", d], capsys)
    path = f"{d}/step_{FIRST:08d}"
    session = reference["session"]
    like = jax.eval_shape(lambda: jdg.init(session.params, session.opt))
    dg = jio.restore(path, like)        # every check of the reference's
    state = JTrainState(algo=dg, env_state={}, obs={}, buffer={},
                        interval=jax.numpy.asarray(FIRST, jax.numpy.int32))
    out = session.run_from(state, REST)
    assert int(out.state.step) == FIRST + REST
    port = _losses(_launch(LAUNCH + ["--steps", str(FIRST + REST),
                                     "--ckpt-dir", d, "--resume"], capsys))
    np.testing.assert_allclose(out.metrics["loss"],
                               [port[i] for i in sorted(port)], rtol=0,
                               atol=LOSS_TOL)
