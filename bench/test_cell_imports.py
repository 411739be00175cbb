"""Nothing the harness loads brings in JAX or the JAX package (top-level
names compared whole: the port's ``repro_torch`` is not ``repro``), and
the reference imports nothing of the program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_IMPORT_ALL = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("bench_run", "bench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from benchlib import cell
for m in json.load(open("BENCHMARK.json"))["per_layer"]:
    cell.metric_module(m["name"])
import repro_torch.api, repro_torch.core.stream_runtime
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_the_harness_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    roots = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in roots and "benchlib" in roots
    assert not roots & FORBIDDEN, roots & FORBIDDEN


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "bench" / "reference").rglob("*.py"))
    assert files
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & (FORBIDDEN | {"repro_torch", "benchlib"}), f
