"""The control, the reference computed one precision step below the
configuration's bfloat16 (fp8 e4m3 products), comes out not correct
against the fp32 reference under each cell's limits and leaf numbers;
at the reduced
configs on the CPU. At the cells' own sizes it is read on the card with
``python3 bench/run.py --control`` (``PERF.md`` gives the readings)."""
from pathlib import Path

import pytest

from benchlib import cell, check, tiny

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 3
CELLS = {"starcoder2-3b.rl-train.s4096": "starcoder2-3b",
         "rwkv6-7b.rl-train.s4096": "rwkv6-7b"}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_fp8_control_fails(name):
    spec = cell.load(name, ROOT).spec
    c = tiny.cell(CELLS[name])
    order = [1, 2, 3]
    ref = cell.reference_readings(c, SEED, "cpu", order)
    low = cell.reference_readings(c, SEED, "cpu", order, precision="fp8")
    ok, checks = check.verdict(
        check.readings(low, ref, spec.get("leaf_stat")), spec["limits"])
    assert not ok, checks
