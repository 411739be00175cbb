"""Training launcher: the HTS-RL learner over a decoder LLM.

Counterpart of ``repro/launch/train.py``, with its flags plus
``--device`` (default ``cuda``; without CUDA it raises unless
``--device cpu`` is given) and ``--n-layers`` (cut the model's depth,
keeping its widths; the config's own depth by default):

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 3 --batch 4 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 4 --batch 2 --seq 16 --device cpu \\
        --ckpt-dir ckpts --ckpt-every 2 [--resume]

The flags become an ``ExperimentSpec`` (env ``token_stream`` x policy
``backbone`` x the optimizer and algorithm x runtime ``stream``) and the
loop is the stream runtime (``core/stream_runtime.py``). The model runs
with ``use_pallas_attention=True``, so on the card every attention,
RG-LRU and RWKV-6 layer takes the hand-written kernels, forward and
backward. A checkpoint is the reference's: the ``DelayedGradState``
alone, in the reference's layout (``bridge.backbone_state_to_reference``),
with ``arch``/``step``/``algorithm``/``opt``/``batch``/``seq`` metadata,
so either package resumes the other's; ``--resume`` checks that metadata
against the flags and continues bit-exactly.
"""
from __future__ import annotations

import argparse
import os
import time

# cuBLAS keeps its bits from run to run with a fixed workspace; set
# before the first handle is made, whatever the caller's environment
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from repro_torch import api, bridge  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import delayed_grad  # noqa: E402
from repro_torch.core.engine import TrainState  # noqa: E402
from repro_torch.models import backbone  # noqa: E402


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="HTS-RL learner over a decoder LLM (repro_torch)")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--opt", default="adam", choices=["adam", "rmsprop"])
    ap.add_argument("--algorithm", default="a2c", choices=["a2c", "ppo"])
    ap.add_argument("--mesh", default="host", choices=["host", "pod",
                                                       "multipod"])
    ap.add_argument("--checkpoint-dir", "--ckpt-dir", dest="ckpt_dir",
                    default=None)
    ap.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                    help="save a checkpoint every N steps (0: only at "
                         "the end, when --checkpoint-dir is set)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint-dir; bit-exact")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    return ap


def main(argv=None) -> api.Session:
    """Runs the flags' training; returns its ``Session`` (a caller in the
    same process reads the trained state from it)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every requires --checkpoint-dir")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --checkpoint-dir")

    spec = api.ExperimentSpec(
        env={"name": "token_stream",
             "kwargs": {"vocab": _vocab_of(args), "batch": args.batch,
                        "seq": args.seq}},
        policy={"name": "backbone",
                "kwargs": {"arch": args.arch, "reduced": args.reduced,
                           "use_pallas_attention": True,
                           **({} if args.n_layers is None
                              else {"n_layers": args.n_layers})}},
        optimizer={"name": args.opt, "kwargs": {"lr": args.lr}},
        algorithm=args.algorithm,
        runtime={"name": "stream", "kwargs": {"mesh": args.mesh}},
        intervals=args.steps)
    session = api.build(spec, device=args.device)
    cfg = session.policy.config
    print(f"{cfg.name}: {backbone.param_count(cfg):,} params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}; "
          f"{args.opt}, {args.algorithm}, batch {args.batch} x seq "
          f"{args.seq} on {session.runtime.device}", flush=True)

    start_step = 0
    state = None
    if args.resume:
        path = ckpt_io.latest(args.ckpt_dir)
        if path is not None:
            meta = ckpt_io.load_metadata(path)
            # anything that changes the update math or the data stream
            # must match, or "resume" would train a different run
            for key, have in (("arch", args.arch),
                              ("algorithm", args.algorithm),
                              ("opt", args.opt), ("batch", args.batch),
                              ("seq", args.seq)):
                if key in meta and meta[key] != have:
                    raise SystemExit(
                        f"checkpoint {path} has {key}={meta[key]!r}, "
                        f"but this run was launched with {have!r}")
            meta_params = dict(backbone.Backbone(
                cfg, device="meta").named_parameters())
            like = bridge.backbone_state_to_reference(
                delayed_grad.init(meta_params, session.opt), cfg)
            dg = bridge.backbone_state_from_jax(ckpt_io.restore(path, like),
                                                cfg)
            start_step = int(meta.get("step", meta.get("steps", 0)))
            state = TrainState(algo=dg, env_state={}, obs={}, buffer={},
                               interval=torch.tensor(start_step,
                                                     dtype=torch.int32))
            print(f"resuming from {path} at step {start_step}", flush=True)

    t0 = time.time()

    @session.on_interval
    def _log(m):
        i = m["interval"]
        if i % args.log_every == 0 or i == args.steps - 1:
            done = i - start_step + 1
            print(f"step {i:4d} loss={m['loss']:.4f} "
                  f"pg={m['pg']:.4f} "
                  f"ent={m['entropy']:.4f} "
                  f"aux={m['aux']:.6g} "
                  f"({(time.time() - t0) / done:.3f}s/step)",
                  flush=True)

    def save_ckpt(state: TrainState, step: int) -> None:
        ckpt_io.save(f"{args.ckpt_dir}/step_{step:08d}",
                     bridge.backbone_state_to_reference(state.algo, cfg),
                     {"arch": args.arch, "step": step,
                      "algorithm": args.algorithm, "opt": args.opt,
                      "batch": args.batch, "seq": args.seq})
        print(f"checkpoint -> {args.ckpt_dir}/step_{step:08d}",
              flush=True)

    done = start_step
    while done < args.steps:
        # segment to the next global ckpt-every multiple (the reference's
        # checkpoint boundaries)
        if args.ckpt_dir and args.ckpt_every:
            stop = min(((done // args.ckpt_every) + 1) * args.ckpt_every,
                       args.steps)
        else:
            stop = args.steps
        # a fresh run starts with run(): the same bits as run_from of the
        # initial capsule, without a host round trip of the whole state
        if state is None:
            session.run(stop - done)
        else:
            session.run_from(state, stop - done)
        # one host capsule at a time: drop the old before taking the new
        state = None
        done = stop
        if args.ckpt_dir and (done < args.steps or args.steps > start_step):
            state = session.state()
            save_ckpt(state, done)
    return session


def _vocab_of(args) -> int:
    """The (possibly reduced) model config's vocab size: what the token
    stream must emit."""
    from repro_torch.configs.base import get_config
    cfg = get_config(args.arch)
    return (cfg.reduced() if args.reduced else cfg).vocab_size


if __name__ == "__main__":
    main()
