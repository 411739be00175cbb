"""End-to-end driver on the PyTorch/CUDA port: HTS-RL training of a
transformer policy.

The counterpart of ``examples/llm_policy_hts.py`` on ``repro_torch``:
env ``token_stream`` x policy ``backbone`` x runtime ``stream`` (the
LLM learner, ``core/stream_runtime.py``: rollouts are collected with the
behavior snapshot, theta_{j-1}, and the learner applies the one-step
delayed gradient). Defaults to a ~4M parameter StarCoder2-family config;
pass --arch/--layers/--d-model to scale.

The behavior-policy accuracy probe rides on ``state()`` capsules between
``run_from`` segments; the training stream itself is untouched.

    PYTHONPATH=src python examples/torch_llm_policy_hts.py --intervals 200

``--device cpu`` runs it without a card.
"""
import argparse
import time

import torch

from repro_torch import api, envs
from repro_torch.models import backbone


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--intervals", type=int, default=200)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = api.ExperimentSpec(
        env={"name": "token_stream",
             "kwargs": {"vocab": args.vocab, "batch": args.batch,
                        "seq": args.seq}},
        policy={"name": "backbone",
                "kwargs": {"arch": args.arch, "reduced": True,
                           "n_layers": args.layers,
                           "d_model": args.d_model,
                           "vocab_size": args.vocab,
                           "d_ff": 4 * args.d_model}},
        optimizer={"name": "adam", "kwargs": {"lr": 3e-4}},
        algorithm="a2c",
        runtime="stream",
        intervals=args.intervals)
    session = api.build(spec, device=args.device)
    device = session.runtime.device

    cfg = session.policy.config
    n_params = backbone.param_count(cfg)
    print(f"policy: {args.arch} reduced -> {n_params / 1e6:.1f}M params")

    @torch.inference_mode()
    def behavior_accuracy(state) -> float:
        """Next-token accuracy of the behavior policy (theta_{j-1}, the
        capsule's params_prev) on the batch the stream serves next."""
        probe = envs.get_env("token_stream", vocab=args.vocab,
                             batch=args.batch, seq=args.seq,
                             device=device).skip(
            1 + int(state.interval)).next_batch()
        model = backbone.from_params(cfg, {
            k: v.to(device) for k, v in state.algo.params_prev.items()})
        h, _, _ = backbone.forward(model, cfg, probe["tokens"])
        logits, _ = backbone.logits_and_value(model, cfg, h)
        return float((torch.argmax(logits, -1) == probe["actions"])
                     .float().mean())

    t0 = time.time()
    correct = []
    state = session.state()
    done = 0
    while done < args.intervals:
        acc = behavior_accuracy(state)
        correct.append(acc)
        print(f"interval {done:4d} behavior-policy accuracy {acc:.3f} "
              f"({(time.time() - t0) / max(done, 1):.2f}s/interval)",
              flush=True)
        chunk = min(20, args.intervals - done)
        session.run_from(state, chunk)
        state = session.state()
        done += chunk
    correct.append(behavior_accuracy(state))
    print(f"accuracy: {correct[0]:.3f} -> {correct[-1]:.3f} "
          f"(reward = correct continuations under the token MDP)")
    return correct


if __name__ == "__main__":
    main()
