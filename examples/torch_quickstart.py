"""Quickstart on the PyTorch/CUDA port: HTS-RL in ~30 lines, through the
declarative surface.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: one
``ExperimentSpec`` names the whole experiment (env x policy x optimizer
x algorithm x runtime x HTSConfig knobs), ``api.build`` resolves it into
a running Session on the card. Trains the paper's A2C on Catch, then
verifies the determinism claim by rebuilding the SAME spec from its
canonical JSON and re-running: the params must be bit-identical.

    PYTHONPATH=src python examples/torch_quickstart.py [--runtime mesh]

``--device cpu`` runs it without a card.
"""
import argparse

import torch

from repro_torch import api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runtime", default="mesh",
                    choices=[n for n in api.runtime_names()
                             if n != "stream"])
    ap.add_argument("--intervals", type=int, default=400)
    ap.add_argument("--staleness", type=int, default=1,
                    help="staleness bound K for the HTS-family runtimes "
                         "(slab-ring depth K+1, delay-K gradient; 1 = "
                         "the paper's double buffer)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = api.ExperimentSpec(
        env="catch",
        policy="mlp",
        optimizer={"name": "rmsprop", "kwargs": {"lr": 7e-4, "eps": 1e-5}},
        algorithm="a2c",
        runtime=args.runtime,
        hts={"alpha": 8, "n_envs": 16, "seed": 0,
             "staleness": args.staleness},
        intervals=args.intervals)

    out = api.build(spec, device=args.device).run()
    r = out.rewards.reshape(args.intervals, -1)
    print(f"[{args.runtime}] {out.steps} steps in {out.wall_time:.1f}s "
          f"({out.sps:.0f} SPS incl. warm-up)")
    print("mean reward per interval block (catch: max +0.111/step):")
    q = max(1, args.intervals // 4)
    for i in range(0, args.intervals, q):
        print(f"  intervals {i:3d}-{i + q - 1:3d}: {r[i:i + q].mean():+.4f}")

    # determinism, end to end: the spec's canonical JSON rebuilds the
    # experiment bit-identically
    out2 = api.build(api.loads(api.dumps(spec)), device=args.device).run()
    identical = all(torch.equal(out.params[k], out2.params[k])
                    for k in out.params)
    print(f"full determinism (bit-identical rerun from the spec JSON): "
          f"{identical}")
    return identical


if __name__ == "__main__":
    main()
