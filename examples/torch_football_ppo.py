"""HTS-RL(PPO) on the mini-football academy drill, on the PyTorch/CUDA
port.

The counterpart of ``examples/football_ppo.py`` on ``repro_torch`` (the
paper's Tab. 2 setting: PPO and a high step-time variance environment),
with the threaded host runtime running the executor, actor and learner
pools and the slab-ring swap. The whole experiment is one declarative
spec: ``--runtime mesh`` (or ``sharded``) runs the identical experiment
on a fused scheduler; only the spec's runtime axis changes.

    PYTHONPATH=src python examples/torch_football_ppo.py --intervals 40

``--device cpu`` runs it without a card.
"""
import argparse

from repro_torch import api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runtime", default="host",
                    choices=[n for n in api.runtime_names()
                             if n != "stream"])
    ap.add_argument("--intervals", type=int, default=40)
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--n-actors", type=int, default=2)
    ap.add_argument("--alpha", type=int, default=16)
    ap.add_argument("--simulate-step-time", action="store_true",
                    help="inject exponential step delays (scaled down; "
                         "host runtime only)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    kw = {}
    if args.runtime != "host" and (args.n_actors != 2
                                   or args.simulate_step_time):
        print(f"note: --n-actors/--simulate-step-time only affect the "
              f"host runtime; ignored for '{args.runtime}'")
    if args.runtime == "host":
        host = {"n_actors": args.n_actors, "time_scale": 0.002}
        if args.simulate_step_time:
            host["step_time"] = {"shape": 1.0, "rate": 1.0}
        kw["host"] = host

    spec = api.ExperimentSpec(
        env="football",
        policy="mlp",
        optimizer={"name": "rmsprop", "kwargs": {"lr": 3e-4, "eps": 1e-5}},
        algorithm="ppo",
        runtime={"name": args.runtime, "kwargs": kw},
        hts={"alpha": args.alpha, "n_envs": args.n_envs, "seed": 0,
             "use_gae": True},
        intervals=args.intervals)

    out = api.build(spec, device=args.device).run()
    r = out.rewards
    print(f"[{args.runtime}] steps: {out.steps}  "
          f"wall: {out.wall_time:.1f}s  SPS: {out.sps:.0f} (incl. warm-up)")
    print(f"goal rate: first 25% {r[:len(r)//4].mean():.4f} -> "
          f"last 25% {r[-len(r)//4:].mean():.4f}")
    return out


if __name__ == "__main__":
    main()
