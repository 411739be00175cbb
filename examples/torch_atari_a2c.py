"""HTS-RL(A2C) vs synchronous A2C vs IMPALA-style async on a pixel env,
on the PyTorch/CUDA port.

The counterpart of ``examples/atari_a2c.py`` on ``repro_torch`` (the
paper's Tab. 1 / Fig. 5 comparison): every contender is one declarative
spec with the same env, policy and optimizer, only the ``runtime`` axis
(and its kwargs) swapped. The paper's conv policy trunk on GridMaze;
final-metric rewards at equal environment steps, and the modeled
wall-clock under a high-variance step-time model (Claim 1's regime).

    PYTHONPATH=src python examples/torch_atari_a2c.py --intervals 120

``--device cpu`` runs it without a card.
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.core.runtime_model import expected_runtime

RUNTIMES = (
    ("mesh", "HTS-RL(A2C)", {}),
    ("sync", "sync A2C", {}),
    ("async", "async+vtrace (k=8)",
     {"acfg": {"staleness": 8, "correction": "vtrace"}}),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--intervals", type=int, default=120)
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--alpha", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    def spec(runtime, kwargs):
        return api.ExperimentSpec(
            env="gridmaze",
            policy={"name": "cnn",
                    "kwargs": {"conv_sizes": [3, 3, 3],
                               "conv_strides": [1, 1, 1], "hidden": 128}},
            optimizer={"name": "rmsprop",
                       "kwargs": {"lr": 7e-4, "eps": 1e-5}},
            algorithm="a2c",
            runtime={"name": runtime, "kwargs": kwargs},
            hts={"alpha": args.alpha, "n_envs": args.n_envs, "seed": 0,
                 "entropy_coef": 0.01},
            intervals=args.intervals)

    def tail(rewards):
        r = np.asarray(rewards)
        return float(r[-max(1, len(r) // 5):].mean())

    print("final-metric reward/step (last 20%):")
    tails = {}
    for name, label, kw in RUNTIMES:
        out = api.build(spec(name, kw), device=args.device).run()
        tails[name] = tail(out.rewards)
        print(f"  {label + ':':<22}{tails[name]:+.4f}")

    # virtual time: same steps, modeled wall-clock (Claim 1 regime:
    # exponential step times, mean 1)
    K = args.intervals * args.alpha * args.n_envs
    t_hts = expected_runtime(K, args.n_envs, args.alpha, beta=1.0)
    t_sync = expected_runtime(K, args.n_envs, 1, beta=1.0) + \
        args.intervals * args.alpha * 0.05   # alternating learner time
    print(f"modeled wall-clock for {K} steps (exp step times): "
          f"HTS-RL {t_hts:.0f}s vs sync-A2C {t_sync:.0f}s "
          f"({t_sync / t_hts:.2f}x speedup)")
    return tails


if __name__ == "__main__":
    main()
