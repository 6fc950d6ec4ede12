"""Numpy-based checkpointing (no external deps).  Port of
`repro.training.checkpoint`.

Two layers:

- **param checkpoints** (`save_checkpoint`/`restore_checkpoint`): one
  tree of arrays or tensors, restored into the structure of a template
  tree.

- **session snapshots** (`save_snapshot`/`load_snapshot`): the full
  crash-safe run state the `repro_torch.api.Session` resume path needs —
  arbitrary named arrays (stacked params, decision vectors, metric
  history) plus a JSON-able meta dict (round, clock, RNG bit-generator
  states, controller scalars).

Both layers write atomically: every file lands under a ``.tmp`` name and
is ``os.replace``d into place, and the ``.json`` sidecar — written
*after* its ``.npz`` — is the commit marker.  A crash mid-write leaves
either a stale tmp file or an npz with no sidecar; ``latest_step`` /
``latest_snapshot`` skip both, so readers only ever see complete pairs.

The reference flattens trees with ``jax.tree_util`` and records
``str(treedef)``; the port flattens with `repro_torch.utils.tree` (dicts
in sorted key order, lists in order) and records its own structure
signature, one ``[path, shape, dtype]`` entry per leaf.  So a port file
is not meant to be read by the reference, nor a reference file by the
port: the signatures differ and each side refuses the other's.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _paths(tree, prefix: str = "") -> list:
    """Leaf paths in `tree_leaves` order: ``"0/w"``, ``"3/proj/b"``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def structure(tree) -> list:
    """The tree's structure signature: ``[path, shape, dtype]`` a leaf."""
    return [[p, list(x.shape), _dtype_name(x)]
            for p, x in zip(_paths(tree), tree_leaves(tree))]


def to_numpy(x) -> np.ndarray:
    """A host copy of a leaf.  bfloat16 tensors, which numpy cannot hold,
    travel as their int16 bit patterns (`from_numpy` reverses it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype is torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy()
    return np.asarray(x)


def from_numpy(arr: np.ndarray, like):
    """A loaded array in ``like``'s form, bitwise: a tensor on ``like``'s
    device and dtype, or a numpy array of its dtype."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if like.dtype is torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device=like.device, dtype=like.dtype)
    return as_leaf_dtype(arr, np.asarray(like).dtype)


def as_leaf_dtype(arr: np.ndarray, dtype) -> np.ndarray:
    """Restore a loaded array to a template leaf's dtype, bitwise.

    Same-width void records (how ``np.load`` returns dtypes numpy does not
    know) are re-viewed by bit pattern — exact — and anything else falls
    back to a cast.
    """
    dtype = np.dtype(dtype)
    if arr.dtype == dtype:
        return arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == dtype.itemsize:
        return arr.view(dtype)
    return arr.astype(dtype)


def atomic_savez(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    # write through a file object — np.savez would append ".npz" to a
    # bare tmp filename and break the rename
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def atomic_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _complete_steps(path: str, prefix: str):
    """Steps under ``path`` whose ``{prefix}_{step}.npz`` is a readable
    archive AND has its ``.json`` commit marker — half-written files
    (crash mid-save, or a stale ``.tmp``) never count."""
    if not os.path.isdir(path):
        return []
    steps = []
    plen = len(prefix) + 1
    for f in os.listdir(path):
        if not (f.startswith(prefix + "_") and f.endswith(".npz")):
            continue
        try:
            step = int(f[plen:-4])
        except ValueError:
            continue
        npz = os.path.join(path, f)
        marker = os.path.join(path, f"{prefix}_{step}.json")
        if os.path.isfile(marker) and zipfile.is_zipfile(npz):
            steps.append(step)
    return steps


def save_checkpoint(path: str, tree, step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": to_numpy(x) for i, x in enumerate(leaves)}
    atomic_savez(os.path.join(path, f"ckpt_{step}.npz"), arrays)
    atomic_json(
        os.path.join(path, f"ckpt_{step}.json"),
        {"structure": structure(tree), "n_leaves": len(leaves),
         "step": step})


def latest_step(path: str):
    steps = _complete_steps(path, "ckpt")
    return max(steps) if steps else None


def restore_checkpoint(path: str, tree_like, step: int = None):
    """Restore into the structure of ``tree_like`` (tensor leaves come
    back on their template's device and dtype).

    Raises ``ValueError`` (not a downstream KeyError/shape blow-up) when
    the checkpoint was written from a different tree structure: leaf
    count or recorded structure mismatch against the template.
    """
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    with open(os.path.join(path, f"ckpt_{step}.json")) as f:
        meta = json.load(f)
    leaves = tree_leaves(tree_like)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint step {step} has {meta['n_leaves']} leaves but the "
            f"template tree has {len(leaves)} — not the same model")
    if meta.get("structure") != structure(tree_like):
        raise ValueError(
            f"checkpoint step {step} structure does not match the template "
            f"tree:\n  saved:    {meta.get('structure')}\n"
            f"  template: {structure(tree_like)}")
    with np.load(os.path.join(path, f"ckpt_{step}.npz")) as data:
        loaded = iter([data[f"leaf_{i}"] for i in range(len(leaves))])
    return tree_map(lambda like: from_numpy(next(loaded), like),
                    tree_like), step


# ---------------------------------------------------------------------------
# Session snapshots (crash-safe resume — DESIGN.md §12)
# ---------------------------------------------------------------------------

SNAPSHOT_VERSION = 1


def save_snapshot(path: str, step: int, arrays: dict, meta: dict) -> None:
    """Write one complete run snapshot at ``step`` (atomic).

    ``arrays``: named numpy arrays (params leaves, decisions, metric
    history).  ``meta``: JSON-able scalars/structures (clock, RNG
    states).  The meta sidecar commits the pair.
    """
    os.makedirs(path, exist_ok=True)
    meta = dict(meta)
    meta["snapshot_version"] = SNAPSHOT_VERSION
    meta["step"] = step
    atomic_savez(
        os.path.join(path, f"snap_{step}.npz"),
        {k: np.asarray(v) for k, v in arrays.items()})
    atomic_json(os.path.join(path, f"snap_{step}.json"), meta)


def latest_snapshot(path: str):
    steps = _complete_steps(path, "snap")
    return max(steps) if steps else None


def load_snapshot(path: str, step: int = None):
    """(arrays dict, meta dict) for ``step`` (default: latest complete)."""
    step = latest_snapshot(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no snapshots under {path}")
    with open(os.path.join(path, f"snap_{step}.json")) as f:
        meta = json.load(f)
    if meta.get("snapshot_version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot step {step} has version "
            f"{meta.get('snapshot_version')!r} != supported "
            f"{SNAPSHOT_VERSION}")
    with np.load(os.path.join(path, f"snap_{step}.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, meta
