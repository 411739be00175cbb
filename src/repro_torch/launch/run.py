"""The spec-driven launcher: one command line over ``repro_torch.api``.

Counterpart of ``repro/launch/run.py``, with the same flags and output
lines, plus ``--device`` (default ``cuda``; without CUDA it raises unless
``--device cpu`` is given):

    PYTHONPATH=src python -m repro_torch.launch.run --spec examples/specs/quickstart.json
    PYTHONPATH=src python -m repro_torch.launch.run --spec spec.json \
        --ckpt-dir ckpts --ckpt-every 10 [--resume]
    PYTHONPATH=src python -m repro_torch.launch.run --spec spec.json \
        --set hts.staleness=2 --set optimizer.kwargs.lr=3e-4
    PYTHONPATH=src python -m repro_torch.launch.run --spec spec.json --print-spec

Flags compose left-to-right onto the spec: ``--spec`` (or the component
flags) produces the base, ``--intervals``/``--runtime``/``--set`` edit
its canonical form, and the result is validated again before anything
is built. ``--print-spec`` emits the final canonical JSON and exits.
With a checkpoint directory (spec ``checkpoint.dir`` or ``--ckpt-dir``)
training runs through the checkpointed trainer, whose files are the
reference's format, and ``--resume`` continues a stopped run bit-exactly.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch import api


def _apply_set(canon: dict, assignment: str) -> None:
    """Apply one ``dotted.path=json_value`` edit to the canonical dict.

    A path segment naming a KNOWN optional block that the dict does not
    carry (a hand-written partial spec without a ``tenancy`` block, say)
    constructs that block's default canonical form in place and keeps
    walking — ``--set tenancy.weight=2`` must mean "default tenancy
    block, weight 2", not KeyError. Only truly unknown names — absent
    from the edited dict AND from a default spec's canonical form —
    fail, loudly, with the path named."""
    if "=" not in assignment:
        raise SystemExit(f"--set takes dotted.path=JSON, got "
                         f"{assignment!r}")
    path, _, raw = assignment.partition("=")
    keys = path.split(".")
    node = canon
    # walk a default spec's canonical form in parallel: it is the
    # authority on which absent names are real optional blocks/fields
    default = api.ExperimentSpec().canonical()
    for key in keys[:-1]:
        if not isinstance(node, dict):
            raise SystemExit(f"--set {path}: {key!r}'s parent is not "
                             f"an object")
        fallback = default.get(key) if isinstance(default, dict) else None
        if key not in node:
            if fallback is None:
                raise SystemExit(
                    f"--set {path}: no such spec field {key!r} "
                    f"(canonical fields: {sorted(node)})")
            node[key] = json.loads(json.dumps(fallback))  # deep copy
        node = node[key]
        default = fallback
    leaf = keys[-1]
    if not isinstance(node, dict):
        raise SystemExit(f"--set {path}: {keys[-2]!r} is not an object")
    # hts knobs and component kwargs may be introduced by an edit;
    # everything else must exist in the canonical form — either in the
    # edited dict or in a default spec's (a partial dict's missing
    # optional field is constructible, a typo is not)
    allow_new = keys[0] == "hts" or "kwargs" in keys[:-1]
    known = isinstance(default, dict) and leaf in default
    if leaf not in node and not (allow_new or known):
        raise SystemExit(f"--set {path}: no such spec field {leaf!r}")
    try:
        node[leaf] = json.loads(raw)
    except ValueError:
        node[leaf] = raw          # bare strings need no quotes


def _override_component(canon: dict, key: str, name: str) -> None:
    """Swap a component's registry name. The spec's kwargs survive when
    the name is unchanged; a genuine swap drops them (they are
    component-specific) — loudly, never silently."""
    cur = canon[key]
    if name == cur["name"]:
        return                    # same component: keep its kwargs
    if cur["kwargs"]:
        print(f"note: --{key} {name} replaces spec {key} "
              f"{cur['name']!r} and drops its kwargs "
              f"{sorted(cur['kwargs'])}", file=sys.stderr)
    canon[key] = {"name": name, "kwargs": {}}


def _resolve_spec(args) -> api.ExperimentSpec:
    if args.spec:
        spec = api.load(args.spec)
    else:
        spec = api.ExperimentSpec(env=args.env)
    canon = spec.canonical()
    if args.env and args.spec:
        _override_component(canon, "env", args.env)
    if args.runtime:
        _override_component(canon, "runtime", args.runtime)
    if args.algorithm:
        canon["algorithm"] = args.algorithm
    if args.intervals is not None:
        canon["intervals"] = args.intervals
    if args.ckpt_dir:
        canon["checkpoint"]["dir"] = args.ckpt_dir
    if args.ckpt_every is not None:
        canon["checkpoint"]["every"] = args.ckpt_every
    for assignment in args.set or ():
        _apply_set(canon, assignment)
    return api.from_dict(canon)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="spec-driven launcher over repro_torch.api")
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="ExperimentSpec JSON (see examples/specs/)")
    ap.add_argument("--env", default=None,
                    help="env registry name (default spec, or 'catch' "
                         "without --spec)")
    ap.add_argument("--runtime", default=None,
                    help="override the spec's runtime registry name")
    ap.add_argument("--algorithm", default=None,
                    help="override the spec's algorithm")
    ap.add_argument("--intervals", type=int, default=None,
                    help="override the spec's run length")
    ap.add_argument("--set", action="append", metavar="PATH=JSON",
                    help="edit any canonical spec field, e.g. "
                         "--set hts.staleness=2")
    ap.add_argument("--ckpt-dir", default=None,
                    help="override checkpoint.dir (enables fit/resume)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="override checkpoint.every")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint")
    ap.add_argument("--log-every", type=int, default=0, metavar="N",
                    help="print per-interval metrics every N intervals "
                         "(0: summary only)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the final canonical spec JSON and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.env is None and args.spec is None:
        args.env = "catch"

    spec = _resolve_spec(args)
    if args.print_spec:
        print(api.dumps(spec, indent=2))
        return
    if args.resume and not spec.checkpoint.dir:
        ap.error("--resume needs a checkpoint dir (spec checkpoint.dir "
                 "or --ckpt-dir)")

    session = api.build(spec, device=args.device)
    if args.log_every:
        @session.on_interval
        def _log(m):
            if m["interval"] % args.log_every:
                return
            if "rewards" in m and np.asarray(m["rewards"]).size:
                print(f"interval {m['interval']:5d} "
                      f"reward/step {np.mean(m['rewards']):+.4f}",
                      flush=True)
            elif "loss" in m:
                print(f"interval {m['interval']:5d} "
                      f"loss {m['loss']:.4f}", flush=True)

    if spec.checkpoint.dir:
        report = session.fit(resume=args.resume)
        print(f"[{spec.runtime.name}] {report.intervals} intervals "
              f"({report.resumed_from} resumed) | {report.steps} steps "
              f"in {report.wall_time:.1f}s ({report.sps:.0f} SPS)")
        if len(report.episode_returns):
            print(f"final metric (mean return, last 100 episodes): "
                  f"{report.final_metric():.3f}")
        return

    out = session.run()
    print(f"[{spec.runtime.name}] {out.steps} steps in "
          f"{out.wall_time:.1f}s ({out.sps:.0f} SPS incl. compile)")
    if out.rewards.size:
        r = out.rewards
        q = max(1, r.shape[0] // 4)
        print(f"reward/step: first {q} intervals "
              f"{r[:q].mean():+.4f} -> last {q} {r[-q:].mean():+.4f}")
    if out.metrics:
        tail = {k: float(np.mean(v[-max(1, len(v) // 4):]))
                for k, v in out.metrics.items()}
        print("tail metrics: " + ", ".join(
            f"{k}={v:.4f}" for k, v in sorted(tail.items())))


if __name__ == "__main__":
    main()
