"""Checkpointing: a flat .npz with a versioned tree manifest.

Counterpart of ``repro/checkpoint/io.py``, in its file format, so that
either package restores what the other wrote. A checkpoint is two files:
``<path>.npz`` holds the leaves (``leaf_<i>``, numbered in
``jax.tree_util`` order: dict keys sorted, NamedTuple fields in order),
``<path>.json`` the manifest: format version, ``n_leaves``, the
structure as JAX's ``str(treedef)`` writes it (``core.tree.treedef_str``),
per-leaf numpy dtype names, shapes and crc32 of the stored bytes, and the
caller's metadata. bf16 leaves are stored as f32 and restored to bf16.
``restore`` checks leaf count, structure, shapes, dtypes and checksums
against the template before it builds anything.

Leaves may be tensors (on any device) or numpy arrays; the layout is the
caller's (the trainer writes the reference's, ``bridge.
train_state_to_reference``). ``restore`` returns leaves of the
template's kind: CPU tensors for tensor leaves, numpy arrays otherwise.
"""
from __future__ import annotations

import json
import os
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten, treedef_str

FORMAT_VERSION = 1


class CheckpointCorrupt(RuntimeError):
    """The checkpoint's BYTES cannot be trusted: the npz half is
    unreadable (truncated write, disk corruption) or a leaf's content
    fails its manifest checksum. Distinct from ValueError (a structural
    mismatch against the restore template): corruption is survivable by
    falling back to an older complete checkpoint (core/trainer.Trainer
    does that), a structural mismatch is a caller error."""


def dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype (``float32``, ``int32``,
    ``bfloat16``), as the reference's manifest records it."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _stored(leaf) -> np.ndarray:
    """The array written for a leaf, on the host: a bf16 tensor upcast to
    f32 (numpy has no bf16), everything else as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays = {}
    dtypes, shapes, crcs = [], [], []
    for i, leaf in enumerate(leaves):
        arr = _stored(leaf)
        dtypes.append(dtype_name(leaf))
        shapes.append(list(arr.shape))
        crcs.append(zlib.crc32(np.ascontiguousarray(arr).tobytes()))
        arrays[f"leaf_{i}"] = arr
    manifest = {
        "version": FORMAT_VERSION,
        "n_leaves": len(leaves),
        "treedef": treedef_str(tree),
        "dtypes": dtypes,
        "shapes": shapes,
        "crc32": crcs,
        "metadata": metadata or {},
    }
    # npz before manifest, each through write-tmp + atomic rename: a kill
    # mid-save leaves no manifest (latest() never selects it) or the old
    # intact pair, never a torn npz behind a valid manifest
    npz_tmp = path.with_suffix(".npz.tmp")
    with open(npz_tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(npz_tmp, path.with_suffix(".npz"))
    json_tmp = path.with_suffix(".json.tmp")
    json_tmp.write_text(json.dumps(manifest, indent=1))
    os.replace(json_tmp, path.with_suffix(".json"))


def _open_npz(path: Path):
    """np.load with byte-level failures surfaced as CheckpointCorrupt."""
    try:
        return np.load(path.with_suffix(".npz"))
    except FileNotFoundError:
        raise CheckpointCorrupt(
            f"checkpoint {path.name} is torn: manifest present but "
            f"{path.with_suffix('.npz').name} is missing") from None
    except Exception as e:      # zipfile.BadZipFile, OSError, EOFError...
        raise CheckpointCorrupt(
            f"checkpoint {path.with_suffix('.npz').name} is unreadable "
            f"(truncated or corrupt): {e!r}") from e


def _read_leaf(data, path: Path, i: int, crcs) -> np.ndarray:
    """Leaf i, decompressed now (np.load is lazy) and checked against its
    manifest checksum when one was recorded."""
    try:
        arr = data[f"leaf_{i}"]
    except KeyError:
        raise CheckpointCorrupt(
            f"checkpoint {path.name} has no leaf_{i} array — the npz "
            f"member list is damaged or the file was truncated") from None
    except Exception as e:      # zlib.error mid-member, struct errors...
        raise CheckpointCorrupt(
            f"checkpoint {path.name} leaf_{i} is unreadable (corrupt "
            f"bytes inside the archive): {e!r}") from e
    if crcs is not None and i < len(crcs):
        got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if got != crcs[i]:
            raise CheckpointCorrupt(
                f"checkpoint {path.name} leaf_{i} fails its checksum "
                f"(manifest crc32={crcs[i]}, stored bytes={got}) — the "
                f"array content was corrupted after the write")
    return arr


def _like(arr: np.ndarray, ref):
    """``arr`` as a leaf of the template's kind and dtype."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(ref.dtype)
    return np.asarray(arr).astype(np.asarray(ref).dtype)


def load_manifest(path: str) -> dict | None:
    p = Path(path).with_suffix(".json")
    return json.loads(p.read_text()) if p.exists() else None


def load_metadata(path: str) -> dict:
    """The caller-supplied metadata dict saved alongside the arrays."""
    m = load_manifest(path)
    return (m or {}).get("metadata", {})


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``. Tree structure, leaf
    count, shapes and dtypes are checked against both the template and
    the manifest before a single leaf is placed."""
    path = Path(path)
    data = _open_npz(path)
    leaves = tree_leaves(like)
    manifest = load_manifest(path)
    if manifest is not None:
        n = manifest.get("n_leaves")
        if n is not None and n != len(leaves):
            raise ValueError(
                f"checkpoint {path.name} has {n} leaves but the restore "
                f"template has {len(leaves)} — the tree structure "
                f"changed (different model/optimizer/runtime config?)")
        want, have = manifest.get("treedef"), treedef_str(like)
        if want is not None and want != have:
            raise ValueError(
                f"checkpoint {path.name} tree structure mismatch:\n"
                f"  saved:    {want}\n  template: {have}")
    if len(data.files) != len(leaves):
        raise ValueError(
            f"checkpoint {path.name} holds {len(data.files)} arrays but "
            f"the restore template has {len(leaves)} leaves")
    crcs = (manifest or {}).get("crc32")
    out = []
    for i, ref in enumerate(leaves):
        arr = _read_leaf(data, path, i, crcs)
        ref_shape = tuple(ref.shape)
        if tuple(arr.shape) != ref_shape:
            # a staleness-K capsule differs from a staleness-K' one only
            # in the leading (ring) axes: name that case
            hint = ""
            if (tuple(arr.shape[1:]) == ref_shape
                    or tuple(arr.shape) == ref_shape[1:]
                    or (arr.ndim == len(ref_shape) and arr.ndim > 0
                        and tuple(arr.shape[1:]) == ref_shape[1:])):
                hint = (" — only the leading (ring) axis differs; was "
                        "this checkpoint written with a different "
                        "staleness than the restoring runtime's?")
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != {ref_shape}"
                f"{hint}")
        if manifest is not None:
            saved_dt = manifest.get("dtypes", [None] * len(leaves))[i]
            if saved_dt is not None and saved_dt != dtype_name(ref):
                raise ValueError(
                    f"leaf {i}: checkpoint dtype {saved_dt} != template "
                    f"dtype {dtype_name(ref)}")
        out.append(_like(arr, ref))
    return tree_unflatten(like, out)


def complete_checkpoints(dirpath: str) -> list[str]:
    """All COMPLETE checkpoints in ``dirpath`` (``step_*.json`` whose
    ``.npz`` half exists), newest first. Content corruption surfaces at
    ``restore`` as CheckpointCorrupt; supervisors walk this list
    newest-first to fall back past it."""
    d = Path(dirpath)
    if not d.exists():
        return []
    return [str(p.with_suffix(""))
            for p in sorted(d.glob("step_*.json"), reverse=True)
            if p.with_suffix(".npz").exists()]


def latest(dirpath: str) -> str | None:
    """Newest complete checkpoint in ``dirpath``, or None."""
    found = complete_checkpoints(dirpath)
    return found[0] if found else None


def restore_prefix(path: str, like: Any) -> Any:
    """Restore the FIRST ``len(tree_leaves(like))`` leaves of a
    checkpoint into the structure of ``like``: the params-only read of a
    full ``TrainState`` capsule (params are the capsule's leading leaves
    for every runtime and staleness). Shapes and dtypes are checked leaf
    by leaf. A missing or unreadable npz or a failed checksum raises
    ``CheckpointCorrupt``; a missing manifest, a manifest without
    ``n_leaves``, too few leaves or a shape/dtype mismatch raises
    ``ValueError``."""
    path = Path(path)
    manifest = load_manifest(path)
    if manifest is None:
        raise ValueError(
            f"checkpoint {path.name} has no manifest "
            f"({path.with_suffix('.json').name} is missing) — cannot "
            f"validate a prefix restore against an unmanifested capsule")
    n = manifest.get("n_leaves")
    if n is None:
        raise ValueError(
            f"checkpoint {path.name} manifest is missing the "
            f"'n_leaves' field (present: {sorted(manifest)})")
    leaves = tree_leaves(like)
    if n < len(leaves):
        raise ValueError(
            f"checkpoint {path.name} holds {n} arrays but the prefix "
            f"template needs {len(leaves)} leaves")
    data = _open_npz(path)
    crcs = manifest.get("crc32")
    dtypes = manifest.get("dtypes", [None] * n)
    out = []
    for i, ref in enumerate(leaves):
        arr = _read_leaf(data, path, i, crcs)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"prefix leaf {i}: checkpoint shape {arr.shape} != "
                f"template {tuple(ref.shape)} — the capsule's leading "
                f"leaves are not this policy's parameters (different "
                f"model config?)")
        if dtypes[i] is not None and dtypes[i] != dtype_name(ref):
            raise ValueError(
                f"prefix leaf {i}: checkpoint dtype {dtypes[i]} != "
                f"template dtype {dtype_name(ref)}")
        out.append(_like(arr, ref))
    return tree_unflatten(like, out)
