"""Witnesses beside a cell's check: how far routes other than the timed
one read from the fp32 reference on the same seeds, weights and batches.

    python3 bench/witness.py --workload <cell> --seed <n> [<n> ...] \
        [--layers N] [--dtype D]

For each seed it reads the fp32 reference once, then each route's first
steps against it: ``kernels`` is the program as the cell runs it,
``plain`` the program with its plain versions in place of the
hand-written kernels, ``bf16-reference`` the reference itself with every
operand of a product rounded to bfloat16. ``--layers`` and ``--dtype``
cut or retype the configuration on every side. Each line of standard
output is one route's readings on one seed, the worst leaf's and the
median leaf's, with the five worst leaves of each leaf number; none is
a cell's result, and nothing is judged.
"""
import argparse
import copy
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

from benchlib import cell as cell_mod  # noqa: E402
from benchlib import check  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class _FirstSteps(cell_mod._Observer):
    """The check's observer, closed once the compared steps are read."""

    def __call__(self, m: dict) -> None:
        super().__call__(m)
        if m["interval"] == cell_mod.COMPARED - 1:
            raise cell_mod._Closed


def _program(cell, seed: int, device) -> tuple:
    """The program's readings of the compared steps, and the pool's
    batches it took."""
    session = cell_mod.setup(cell, seed, device)
    obs = _FirstSteps(session, cell_mod.COMPARED, 0.0, False)
    session.on_interval(obs)
    try:
        session.run(cell_mod.COMPARED)
    except cell_mod._Closed:
        pass
    out = {"terms": obs.terms, "grad": obs.grad, "change": obs.change}
    order = session.runtime.stream.served
    del session, obs
    cell_mod._free(device)
    return out, order


def _line(route: str, seed: int, cell, got: dict, ref: dict) -> str:
    stats = {stat: check.readings(got, ref,
                                  dict.fromkeys(("grad", "change"), stat))
             for stat in ("worst", "median")}
    top = {key: [[n, g, p, r] for n, g, p, r in check.ranked(got, ref, key)]
           for key in ("grad", "change")}
    return json.dumps({"witness": route, "workload": cell.name,
                       "seed": seed, "layers": cell.cfg["num_hidden_layers"],
                       "dtype": cell.cfg["torch_dtype"], **stats,
                       "top": top})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--dtype")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        _log("the witnesses run on a CUDA device; none is here")
        return 2
    device = torch.device("cuda")
    cell = cell_mod.load(args.workload)
    port = cell.cfg["port"]
    if args.layers:
        cell.cfg["num_hidden_layers"] = port["n_layers"] = args.layers
    if args.dtype:
        cell.cfg["torch_dtype"] = port["dtype"] = args.dtype
    for seed in args.seed:
        progs = {}
        for route in ("kernels", "plain"):
            c = copy.deepcopy(cell)
            c.cfg["port"]["use_pallas_attention"] = route == "kernels"
            progs[route], order = _program(c, seed, device)
        ref = cell_mod.reference_readings(cell, seed, device, order,
                                          log=_log)
        progs["bf16-reference"] = cell_mod.reference_readings(
            cell, seed, device, order, precision="bf16", log=_log)
        for route, got in progs.items():
            print(_line(route, seed, cell, got, ref), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
