"""A run of the harness with the timed path broken underneath comes out
not correct, under the limits of the cell: a step that leaves the state
unchanged, half of each batch left out of the loss, and the learner
without its delay (the gradient taken at the parameters it updates, not
at the one-update-old ones). The run is the harness's own (``cell.run``)
past its look for a card, on the CPU at the reduced configs. A clean
run comes out correct under the reduced cells' own limits (the cells'
are set for their sizes, §6 of PERF.md); at the reduced sizes some of a
cell's numbers read over its limits with no fault at all, so each fault
has to fail a number that a clean run of the same seed passes."""
import time
from pathlib import Path

import pytest

from benchlib import cell, tiny

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 7
CASES = [("starcoder2-3b.rl-train.s4096", None, True),
         ("starcoder2-3b.rl-train.s4096", "half_batch", False),
         ("starcoder2-3b.rl-train.s4096", "frozen", False),
         ("starcoder2-3b.rl-train.s4096", "undelayed", False),
         ("rwkv6-7b.rl-train.s4096", "half_batch", False),
         ("rwkv6-7b.rl-train.s4096", "frozen", False),
         ("rwkv6-7b.rl-train.s4096", "undelayed", False)]


def _run(name: str, fault, limits: dict):
    c = tiny.cell(name.split(".")[0], limits=limits)
    c.spec["leaf_stat"] = cell.load(name, ROOT).spec.get("leaf_stat")
    return cell.run(c, SEED, 0.05, False, "cpu", time.perf_counter(),
                    fault=fault)


def _failing(out: dict) -> set:
    return {k for k, c in out["checks"].items()
            if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("name, fault, correct", CASES)
def test_a_broken_step_fails_the_check(name, fault, correct):
    limits = cell.load(name, ROOT).spec["limits"] if fault else tiny.LIMITS
    out = _run(name, fault, limits)
    assert out["correct"] is correct, out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(limits)
    if fault:
        clean = _run(name, None, limits)
        assert _failing(out) - _failing(clean), (out["checks"],
                                                 clean["checks"])
