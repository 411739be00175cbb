"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``: a configuration
(``bench/configs/``), a traffic mix (``bench/traffic/``) and the cell's
own file (``bench/workloads/<cell>.json``: learning rate, warm-up
steps, the limits of the check). ``--trace 0`` measures the end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` traces a window
with torch.profiler and reads the per-layer metrics
(``bench/metrics/<metric>.py``). Either way the first steps are checked
against the plain reference (``bench/reference/``) once the window has
closed. The last line of standard output is the result's JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

``--fault half_batch|frozen|undelayed`` breaks the timed path on
purpose, and ``--control`` judges the reference in fp8 against the
reference under the cell's limits for each ``--seed`` given; both serve
to set and test the limits.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# cuBLAS keeps its bits from run to run with a fixed workspace; set before
# the first handle is made, as the program's training launcher does
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

from benchlib import cell as cell_mod  # noqa: E402
from benchlib import check  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=cell_mod.FAULTS)
    ap.add_argument("--control", action="store_true")
    return ap


def _control(cell, seeds) -> None:
    """The fp8 control against the fp32 reference under the cell's
    limits, a line per seed: each number beside its limit, and whether the
    control fails them (it has to)."""
    for seed in seeds:
        ref = cell_mod.reference_readings(cell, seed, "cuda", _order(),
                                          log=_log)
        low = cell_mod.reference_readings(cell, seed, "cuda", _order(),
                                          precision="fp8", log=_log)
        ok, checks = check.verdict(
            check.readings(low, ref, cell.spec.get("leaf_stat")),
            cell.spec["limits"])
        print(json.dumps({"control": "fp8", "seed": seed, "fails": not ok,
                          "terms": {"reference": ref["terms"],
                                    "control": low["terms"]},
                          "checks": checks}), flush=True)


def _order():
    """The pool's batches the program's first steps take: its runtime skips
    batch 0 (its launcher's shape probe)."""
    return list(range(1, 1 + cell_mod.COMPARED))


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cell = cell_mod.load(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA device(s); this "
             f"machine has {have}")
        return 2
    _log(f"card: {_power_limit()}")
    if args.control:
        _control(cell, args.seed)
        return 0
    if len(args.seed) != 1:
        _log("a run takes one --seed")
        return 2
    out = cell_mod.run(cell, args.seed[0], args.seconds, bool(args.trace),
                       "cuda", T_PROCESS, fault=args.fault, log=_log)
    found = cell_mod.forbidden_modules()
    if found:
        _log(f"modules loaded that the benchmark forbids: {found}")
        return 3
    _log(f"correct: {out['correct']}")
    for name, c in out["checks"].items():
        leaf = f" (leaf {c['leaf']})" if "leaf" in c else ""
        _log(f"check {name}: {c['value']:.6g} limit {c['limit']:.6g}{leaf}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
