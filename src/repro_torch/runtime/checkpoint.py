"""Atomic, resumable checkpoints.

Port of `src/repro/runtime/checkpoint.py`, with the same on-disk layout
(one directory per step):

    <root>/step_00000420.tmp-<nonce>/     # written here first
        manifest.json                     # tree structure, shapes, dtypes,
                                          # sha256 per leaf, user metadata
        leaf_00000.npy ... leaf_NNNNN.npy
    <root>/step_00000420/                 # atomic os.replace when complete
    <root>/LATEST                         # text file, atomically replaced

  * a checkpoint directory either exists completely or not at all (tmp dir
    + rename; a crash mid-write leaves only a .tmp-* that restore ignores);
  * integrity is verifiable (sha256 per leaf, checked on restore);
  * old steps are garbage-collected (``keep`` newest survive);
  * `AsyncCheckpointer` moves hashing and file IO off the step loop (the
    snapshot to host memory is taken synchronously, so it is consistent).

The state is any nesting of dicts, tuples, lists and NamedTuples with
tensors, numpy arrays or Python numbers at the leaves (the trainer's
``(params, OptState)``).  It is flattened by `_leaves` below in
`jax.tree_util`'s order (dict keys sorted, None an empty subtree), so a
tree of the same structure maps to the same leaf files in both packages.
A tensor leaf restores onto the device and dtype of the matching leaf of
``tree_like``; bfloat16, which numpy lacks, is stored as float32.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from typing import Any, Iterator, Optional

import numpy as np
import torch

Tree = Any

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "available_steps", "AsyncCheckpointer", "CheckpointError"]


class CheckpointError(RuntimeError):
    pass


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Tree) -> list:
    """The tree's leaves, depth first (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _leaves(child)]
    return [tree]


def _rebuild(like: Tree, leaves: Iterator) -> Tree:
    """A tree shaped like ``like`` with its leaves taken from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        built = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return type(like)((k, built[k]) for k in like)
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(c, leaves) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


def _structure(tree: Tree) -> str:
    """A readable description of the tree's containers (the manifest's
    ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (type(tree).__name__ + "("
                + ", ".join(_structure(c) for c in tree) + ")")
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_structure(c) for c in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _from_host(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def save_checkpoint(root: str, step: int, tree: Tree, *,
                    metadata: Optional[dict] = None, keep: int = 3,
                    verify: bool = True) -> str:
    """Write one atomic checkpoint; returns the final directory path."""
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    flat = _leaves(tree)
    leaves_meta = []
    try:
        for i, leaf in enumerate(flat):
            arr = _to_host(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            leaves_meta.append({
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": _sha256(arr) if verify else None,
            })
        manifest = {
            "step": step,
            "treedef": _structure(tree),
            "num_leaves": len(flat),
            "leaves": leaves_meta,
            "metadata": metadata or {},
            "written_at": time.time(),
            "format_version": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, final)          # atomic publish
    except BaseException:
        # best-effort cleanup of the partial tmp dir
        try:
            for fn in os.listdir(tmp):
                os.unlink(os.path.join(tmp, fn))
            os.rmdir(tmp)
        except OSError:
            pass
        raise
    _write_latest(root, step)
    _gc(root, keep)
    return final


def _write_latest(root: str, step: int):
    tmp = os.path.join(root, f".LATEST.tmp-{uuid.uuid4().hex[:8]}")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(root, "LATEST"))


def _gc(root: str, keep: int):
    steps = available_steps(root)
    for s in steps[:-keep] if keep > 0 else []:
        d = _step_dir(root, s)
        for fn in os.listdir(d):
            os.unlink(os.path.join(d, fn))
        os.rmdir(d)


def available_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and ".tmp-" not in name:
            if os.path.exists(os.path.join(root, name, "manifest.json")):
                out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    """Prefer the LATEST pointer; fall back to a directory scan."""
    path = os.path.join(root, "LATEST")
    steps = available_steps(root)
    if os.path.exists(path):
        try:
            with open(path) as f:
                s = int(f.read().strip())
            if s in steps:
                return s
        except ValueError:
            pass
    return steps[-1] if steps else None


def restore_checkpoint(root: str, tree_like: Tree, *,
                       step: Optional[int] = None,
                       verify: bool = True) -> tuple[Tree, dict]:
    """Load a checkpoint into the structure of ``tree_like`` (each leaf on
    the device and in the dtype of ``tree_like``'s leaf).  Returns
    ``(tree, metadata)``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise CheckpointError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _leaves(tree_like)
    if manifest["num_leaves"] != len(flat_like):
        raise CheckpointError(
            f"leaf count mismatch: checkpoint has {manifest['num_leaves']}, "
            f"target structure has {len(flat_like)}")
    out = []
    for i, (meta, like) in enumerate(zip(manifest["leaves"], flat_like)):
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and meta.get("sha256"):
            h = _sha256(arr)
            if h != meta["sha256"]:
                raise CheckpointError(
                    f"integrity failure in leaf {i} ({meta['file']}): "
                    f"sha256 {h[:12]} != manifest {meta['sha256'][:12]}")
        want_shape = tuple(getattr(like, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise CheckpointError(
                f"shape mismatch leaf {i}: checkpoint {arr.shape} vs "
                f"target {want_shape}")
        out.append(_from_host(arr, like))
    return _rebuild(tree_like, iter(out)), manifest.get("metadata", {})


class AsyncCheckpointer:
    """Snapshot synchronously, serialize and write in a background thread.

    `save(step, tree)` blocks only for the device-to-host copy of the
    snapshot (the consistency point); hashing, npy IO and the rename happen
    off-thread.  `wait()` joins the in-flight write (call it before process
    exit and before reading LATEST).  A failed write surfaces on the next
    save or wait.
    """

    def __init__(self, root: str, *, keep: int = 3, verify: bool = True):
        self.root = root
        self.keep = keep
        self.verify = verify
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(f"previous async checkpoint failed: {err!r}")

    def save(self, step: int, tree: Tree, metadata: Optional[dict] = None):
        self.wait()
        self._check_error()
        host_tree = _rebuild(tree, iter([_to_host(x) for x in _leaves(tree)]))

        def work():
            try:
                save_checkpoint(self.root, step, host_tree,
                                metadata=metadata, keep=self.keep,
                                verify=self.verify)
            except BaseException as e:   # surfaced on next save/wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._check_error()
