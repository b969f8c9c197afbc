"""Checkpointing with atomic commits, async writes and auto-resume: the JAX
package's ``src/repro/ckpt/__init__.py``, in its on-disk format.

Layout (one directory per step)::

    <dir>/step_000000120/
        manifest.json            # every leaf's key, shape and dtype
        shard_p0.npz             # this process's leaves
        COMMIT                   # written last: the checkpoint is valid iff present

A leaf's key is its path in the tree, as the reference writes it: dict
keys, sequence indices and NamedTuple field names joined by ``/``
(``0/embedding/emb``, ``1/step``, ``1/mu/tail/0/...``), with ``/`` written
as ``__`` inside the npz. A bf16 tensor is stored as the reference stores
it, as 2-byte raw values (numpy dtype ``|V2``) with ``"dtype": "bfloat16"``
in the manifest; ``restore`` reads that dtype and views the bytes as
``torch.bfloat16``. (The reference's own ``restore`` cannot read such a
leaf back: ``jnp.asarray`` of ``|V2`` bytes raises.) One process writes
everything here (``shard_p0``); the reference's per-process shards wait for
the mesh.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import flatten_with_paths, unflatten

COMMIT = "COMMIT"
_STEP_RE = re.compile(r"^step_(\d{9})$")
_BF16 = "bfloat16"


def _flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in flatten_with_paths(tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array as written to the npz, the manifest's dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:        # a bf16 numpy array (ml_dtypes)
        return arr.view(np.dtype("V2")), _BF16
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr, order="C")          # keeps a 0-d leaf 0-d
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(dir_: str, step: int, tree: Any, *, extra: Optional[Dict] = None
         ) -> str:
    """Synchronous save with atomic commit."""
    step_dir = os.path.join(dir_, f"step_{step:09d}")
    os.makedirs(step_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        arrays[key] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    # atomic per-file writes: tmp + rename
    shard_path = os.path.join(step_dir, "shard_p0.npz")
    fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **{k.replace("/", "__"): v for k, v in arrays.items()})
    os.replace(tmp, shard_path)
    mpath = os.path.join(step_dir, "manifest.json")
    fd, tmp = tempfile.mkstemp(dir=step_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)
    # commit marker LAST: restore ignores uncommitted checkpoints
    with open(os.path.join(step_dir, COMMIT), "w") as f:
        f.write("ok")
    return step_dir


def latest_step(dir_: str) -> Optional[int]:
    """Newest *committed* checkpoint step, or None."""
    if not os.path.isdir(dir_):
        return None
    steps = []
    for name in os.listdir(dir_):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(dir_, name, COMMIT)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(dir_: str, tree_like: Any, *, step: Optional[int] = None,
            device=None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (its leaves are not
    read): (tree of CPU tensors, or on ``device``; step; extra). Every
    shard file of the step is read, whichever process wrote it."""
    step = step if step is not None else latest_step(dir_)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {dir_}")
    step_dir = os.path.join(dir_, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(step_dir)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(step_dir, name)) as z:
                for k in z.files:
                    data[k.replace("__", "/")] = z[k]
    new_leaves = []
    for key, _ in _flatten_with_paths(tree_like):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _to_tensor(data[key], manifest["leaves"][key]["dtype"])
        new_leaves.append(t if device is None else t.to(device))
    return unflatten(tree_like, new_leaves), step, manifest.get("extra", {})


def retain(dir_: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(dir_):
        return
    steps = sorted(
        int(m.group(1)) for m in (_STEP_RE.match(n) for n in os.listdir(dir_))
        if m)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(dir_, f"step_{s:09d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Fire-and-forget checkpointing off the training thread.

    ``maybe_save`` takes ownership of the tree: it copies each leaf that
    lies on a device to the host on the caller's thread, takes a host leaf
    as it is, and hands serialization to a worker. So the caller must not
    change a host tensor it handed over (``launch.train`` hands over a
    fresh copy in the reference's layout), which is copied only once. A
    new save while one is in flight blocks until the previous one commits
    (bounded memory).
    """

    def __init__(self, dir_: str, *, keep: int = 3):
        self.dir = dir_
        self.keep = keep
        self._worker: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def maybe_save(self, step: int, tree: Any, *, extra: Optional[Dict] = None):
        self.wait()
        host = unflatten(tree, [
            l.detach().cpu() if isinstance(l, torch.Tensor) else np.asarray(l)
            for _, l in flatten_with_paths(tree)])

        def work():
            save(self.dir, step, host, extra=extra)
            retain(self.dir, self.keep)
            self.saved_steps.append(step)

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()


__all__ = ["COMMIT", "save", "latest_step", "restore", "retain",
           "AsyncCheckpointer"]
