"""The public surface of the port against the reference's, read by ``ast``
with no import.

Every public top-level ``def`` and ``class`` of a module under
``src/repro/`` has a top-level name of the same spelling in the same
module path under ``src/repro_torch/`` (defined, assigned or imported
there), or an entry in ``RENAMED``: the port's counterpart under another
name or in another module (which must exist), or a one-line reason where
there is none. An entry whose reference name is gone, or which names a
reference name the port already has under the same spelling, fails, so
the table cannot rot.
"""
import ast
import re
from functools import lru_cache
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

# "module:name" of the reference -> "module:name" of the port, or a reason
RENAMED = {
    "core.distributed:global_data_mesh": "core.distributed:global_data_group",
    "kernels:on_tpu": "kernels:use_kernel_for",
    "kernels:resolve_backend": "kernels:use_kernel_for",
    "launch.mesh:as_shardings": "launch.mesh:as_placements",
    "models.attention:init_attention": "models.attention:Attention",
    "models.attention:attend": "kernels.flash_attention.ops:attend",
    "models.backbone:abstract_params":
        "no shape-only params tree: the dry run (launch/dryrun.py) builds "
        "the params as FakeTensors",
    "models.layers:init_norm": "models.layers:Norm",
    "models.layers:apply_norm": "models.layers:Norm",
    "models.layers:init_mlp": "models.layers:MLP",
    "models.layers:apply_mlp": "models.layers:MLP",
    "models.layers:init_embed": "models.backbone:Backbone",
    "models.moe:init_moe": "models.moe:MoE",
    "models.rglru:init_rglru": "models.rglru:RGLRU",
    "models.rwkv6:init_rwkv6": "models.rwkv6:RWKV6",
    # XLA's HLO text has no counterpart: the port counts eager ops,
    # collectives included, under a dispatch mode
    "roofline.analysis:CollectiveStats": "roofline.op_cost:OpCost",
    "roofline.analysis:parse_collectives": "roofline.op_cost:OpCost",
    "roofline.hlo_cost:Costs": "roofline.op_cost:OpCost",
    "roofline.hlo_cost:HloCostModel": "roofline.op_cost:OpCost",
    "roofline.hlo_cost:analyze": "roofline.op_cost:OpCost",
    "sharding.rules:param_pspecs": "sharding.rules:param_specs",
    "sharding.rules:opt_state_pspecs": "sharding.rules:opt_state_specs",
    "sharding.rules:dg_state_pspecs": "sharding.rules:dg_state_specs",
    "sharding.rules:cache_pspecs": "sharding.rules:cache_specs",
}
COUNTERPART = re.compile(r"^[\w.]+:\w+$")


def _path(root: Path, module: str) -> Path:
    base = root.joinpath(*module.split(".")) if module else root
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _module(path: Path) -> str:
    parts = path.relative_to(REF).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


@lru_cache(maxsize=None)
def _tree(path: Path):
    return ast.parse(path.read_text()) if path.exists() else None


def public_defs(module: str) -> list:
    """Public top-level ``def``s and ``class``es of a reference module."""
    tree = _tree(_path(REF, module))
    return [n.name for n in (tree.body if tree else ())
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def bound_names(module: str) -> set:
    """Every name a port module binds at top level."""
    tree = _tree(_path(PORT, module))
    out = set()
    for n in (tree.body if tree else ()):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out |= {x.id for x in ast.walk(t) if isinstance(x, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


MODULES = sorted(m for m in {_module(p) for p in REF.rglob("*.py")}
                 if public_defs(m))


def test_the_walk_sees_the_reference():
    assert len(MODULES) > 70
    assert "train" in public_defs("core.mesh_runtime")
    assert {"has_device_port", "get_device_env"} <= set(public_defs("envs"))
    assert "make_device_env" in public_defs("envs.device")


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    ours = bound_names(module)
    missing = []
    for name in public_defs(module):
        entry = RENAMED.get(f"{module}:{name}")
        if entry is None:
            if name not in ours:
                missing.append(name)
        elif COUNTERPART.match(entry):
            mod, other = entry.split(":")
            assert other in bound_names(mod), (name, entry)
    assert not missing, (
        f"repro.{module} has public names the port lacks: {missing}")


@pytest.mark.parametrize("entry", sorted(RENAMED))
def test_table_entries_name_live_reference_names(entry):
    module, name = entry.split(":")
    assert name in public_defs(module), f"{entry} is gone from the reference"
    assert name not in bound_names(module), (
        f"the port has {entry} under the same name: drop the entry")
    if not COUNTERPART.match(RENAMED[entry]):
        assert RENAMED[entry] and "\n" not in RENAMED[entry]


def test_the_functional_entry_point_and_env_names_need_no_entry():
    for module, name in (("core.mesh_runtime", "train"),
                         ("envs", "has_device_port"),
                         ("envs", "get_device_env"),
                         ("envs.device", "make_device_env")):
        assert f"{module}:{name}" not in RENAMED
        assert name in bound_names(module)
