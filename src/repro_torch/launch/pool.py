"""Multi-tenant launcher: admit several spec files into one TenantPool
(``repro_torch.tenancy``) and time-slice the device between them.

Counterpart of ``repro/launch/pool.py``, with its flags plus
``--device`` (default ``cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.pool \
        --spec examples/specs/pool_a.json --spec examples/specs/pool_b.json
    PYTHONPATH=src python -m repro_torch.launch.pool \
        --spec a.json --spec b.json --weight 2 --weight 1 --sequential
    PYTHONPATH=src python -m repro_torch.launch.pool \
        --spec a.json --spec b.json --digest --check-solo

``--weight``/``--name`` repeat and align with ``--spec`` by position,
overriding each spec's ``tenancy`` block. ``--digest`` prints one digest
line per tenant (sha256 over final params, reward stream and episode
returns). ``--check-solo`` then runs every tenant alone in the same
process and exits non-zero unless each pooled digest equals its solo
digest.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np


def result_digest(params, rewards, episode_returns) -> str:
    """sha256 over a result's arrays: params leaves in tree order, then
    the reward stream, then the episode returns."""
    from repro_torch.core.tree import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(np.ascontiguousarray(leaf.detach().cpu().numpy()).tobytes())
    h.update(np.ascontiguousarray(np.asarray(rewards)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(episode_returns)).tobytes())
    return h.hexdigest()


def jain_index(values) -> float:
    """Jain's fairness index over per-tenant (weight-normalized) shares:
    1.0 = perfectly proportional, 1/n = one tenant got everything."""
    x = np.asarray(list(values), dtype=np.float64)
    if x.size == 0 or not x.sum():
        return float("nan")
    return float(x.sum() ** 2 / (x.size * (x ** 2).sum()))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-tenant pool launcher over repro_torch.tenancy")
    ap.add_argument("--spec", action="append", required=True,
                    metavar="FILE", help="ExperimentSpec JSON; repeat "
                    "once per tenant")
    ap.add_argument("--weight", action="append", type=int, default=None,
                    help="fair-share weight, aligned with --spec by "
                    "position (default: each spec's tenancy.weight)")
    ap.add_argument("--name", action="append", default=None,
                    help="tenant name, aligned with --spec by position "
                    "(default: tenancy.name or t<index>)")
    ap.add_argument("--intervals", type=int, default=None,
                    help="override every tenant's interval budget")
    ap.add_argument("--max-concurrency", type=int, default=2,
                    help="slices in flight across distinct tenants "
                    "(results are identical for every value)")
    ap.add_argument("--sequential", action="store_true",
                    help="shorthand for --max-concurrency 1")
    ap.add_argument("--digest", action="store_true",
                    help="print per-tenant result digests")
    ap.add_argument("--check-solo", action="store_true",
                    help="re-run each tenant solo and fail unless the "
                    "pooled digests match")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap, ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the pool; returns ``{name: TenantResult}``. Exits 1 when
    ``--check-solo`` finds a tenant whose pooled digest is not its solo
    one."""
    from repro_torch import api
    from repro_torch.core import evaluate
    ap, args = parse_args(argv)
    specs = [api.load(p) for p in args.spec]
    if args.intervals is not None:
        specs = [s.replace(intervals=args.intervals) for s in specs]
    for flag, vals in (("--weight", args.weight), ("--name", args.name)):
        if vals is not None and len(vals) != len(specs):
            ap.error(f"{flag} repeats must align with --spec: got "
                     f"{len(specs)} spec(s), {len(vals)} value(s)")

    pool = api.Session.pool(
        specs, weights=args.weight, names=args.name,
        max_concurrency=1 if args.sequential else args.max_concurrency,
        device=args.device)
    t0 = time.perf_counter()
    results = pool.run()
    wall = time.perf_counter() - t0

    total_steps = sum(r.steps for r in results.values())
    counts = pool.schedule_counts()
    weights = {name: pool._get(name).weight for name in results}
    shares = [counts[n] / weights[n] for n in results]
    print(f"[pool] {len(results)} tenants | {total_steps} steps in "
          f"{wall:.1f}s ({total_steps / max(wall, 1e-9):.0f} aggregate "
          f"SPS) | Jain fairness {jain_index(shares):.3f}")
    for name, r in results.items():
        print(f"  {name}: {r.intervals}/{r.target} intervals, "
              f"{r.steps} steps, weight {weights[name]}, "
              f"status {r.status}")

    digests = {name: result_digest(r.params, r.rewards, r.episode_returns)
               for name, r in results.items()}
    if args.digest or args.check_solo:
        for name, d in digests.items():
            print(f"  digest {name} {d}")

    if args.check_solo:
        failed = []
        for name, spec in zip(results, specs):
            r = results[name]
            solo = api.build(spec, device=args.device).run(r.target)
            s = evaluate.ReturnStream(spec.hts_config().n_envs)
            if solo.rewards.size:
                s.extend(solo.rewards, solo.dones)
            d = result_digest(solo.params, solo.rewards, s.returns)
            ok = d == digests[name]
            print(f"  solo   {name} {d} "
                  f"{'== pooled OK' if ok else '!= pooled MISMATCH'}")
            if not ok:
                failed.append(name)
        if failed:
            print(f"[pool] determinism check FAILED for {failed}",
                  file=sys.stderr)
            raise SystemExit(1)
        print("[pool] every tenant bit-exact to its solo run")
    sys.stdout.flush()
    return results


if __name__ == "__main__":
    main()
