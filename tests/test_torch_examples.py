"""The port's examples (``examples/torch_*.py``) at their smallest
arguments on the CPU.

Each takes its reference example's flags (and ``--device``), runs in
process through ``main(argv)`` and prints its reference's lines:
``torch_quickstart`` its bit-identical rerun ``True``,
``torch_atari_a2c`` the three contenders' tail rewards and the modeled
speedup, ``torch_football_ppo`` the goal rate on the football env,
``torch_llm_policy_hts`` the behavior-policy accuracy probe.
"""
import importlib.util
import re
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]
RUNS = {
    "quickstart": ["--intervals", "4"],
    "atari_a2c": ["--intervals", "1", "--alpha", "1", "--n-envs", "2"],
    "football_ppo": ["--intervals", "4", "--alpha", "4", "--n-envs", "2"],
    "llm_policy_hts": ["--intervals", "2", "--layers", "1", "--d-model",
                       "64", "--batch", "2", "--seq", "8", "--vocab", "64"],
}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(path: Path) -> set:
    return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"',
                          path.read_text()))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_with_the_reference_flags(name, capsys):
    assert _flags(EXAMPLES / f"torch_{name}.py") == \
        _flags(EXAMPLES / f"{name}.py") | {"--device"}
    src = (EXAMPLES / f"torch_{name}.py").read_text()
    assert "import jax" not in src and "from repro " not in src
    result = _load(name).main(RUNS[name] + CPU)
    out = capsys.readouterr().out
    if name == "quickstart":
        assert result is True
        assert ("full determinism (bit-identical rerun from the spec "
                "JSON): True") in out
    elif name == "atari_a2c":
        assert set(result) == {"mesh", "sync", "async"}
        for label in ("HTS-RL(A2C):", "sync A2C:", "async+vtrace (k=8):"):
            assert label in out
        assert "speedup" in out
    elif name == "football_ppo":
        assert result.steps == 4 * 4 * 2
        assert "[host] steps: 32" in out and "goal rate:" in out
    else:
        assert len(result) == 2
        assert "behavior-policy accuracy" in out and "accuracy:" in out
