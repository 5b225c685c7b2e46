"""Checkpoints of the outer state: an npz of every leaf, a manifest and a
content hash; atomic writes; an optional background saver.

Port of ``repro/checkpoint/ckpt.py``. A tree is the engine's
``server_tree()``: a dict whose entries are ``{path: tensor}`` dicts
(``params``, ``momentum``, ``aux``) or a leaf (``step``). The file's keys
are the reference's (``params/<path>``, ``step``), its arrays have the
reference's dtypes (the outer step a 0-d int32, as the reference's
``OuterState.step``), and the hash is the reference's sha256 over the
sorted keys and their bytes, so each package restores the other's file
bit for bit. The manifest's ``structure`` is the port's own description of
the tree; ``restore`` never reads it.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Mapping[str, Any]
_SEP = "/"


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its bytes: a tensor copied to the
    host (a copy even on the CPU, so that a later in-place update of the
    tensor cannot reach it), the step (the one int leaf) as the
    reference's int32."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf, np.int32)


def _items(tree: Tree):
    """(key, leaf) pairs of a tree of dicts, keys joined by "/"."""
    for name, value in tree.items():
        if isinstance(value, Mapping):
            for sub, leaf in _items(value):
                yield f"{name}{_SEP}{sub}", leaf
        else:
            yield str(name), value


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _items(tree)}


def _digest(flat: Mapping[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(memoryview(np.ascontiguousarray(flat[k])).cast("B"))
    return h.hexdigest()


def tree_structure_manifest(tree: Tree) -> str:
    """The tree's top-level entries and their leaf counts."""
    return ", ".join(
        f"{name}: {len(v)} leaves" if isinstance(v, Mapping) else
        f"{name}: leaf" for name, v in sorted(tree.items()))


def _write(path: str, flat: Dict[str, np.ndarray], structure: str,
           meta: Optional[Dict]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    digest = _digest(flat)
    manifest = {
        "hash": digest,
        "structure": structure,
        "meta": meta or {},
        "keys": sorted(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
    }
    mtmp = path + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, path + ".manifest.json")
    return digest


def save(path: str, tree: Tree, meta: Optional[Dict] = None) -> str:
    """Atomic save; returns the content hash."""
    return _write(path, _flatten(tree), tree_structure_manifest(tree), meta)


def restore(path: str, like: Tree) -> Tuple[Dict, Dict]:
    """Restore into the structure of ``like``: each tensor leaf on its
    device and in its dtype, an int leaf as an int. Verifies the content
    hash; raises ``IOError`` on a mismatch or a missing key."""
    with open(path + ".manifest.json") as f:
        manifest = json.load(f)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if _digest(flat) != manifest["hash"]:
        raise IOError(f"checkpoint {path} corrupt: hash mismatch")
    missing = {k for k, _ in _items(like)} - set(flat)
    if missing:
        raise IOError(f"checkpoint missing keys: {sorted(missing)[:5]}...")

    def build(tree: Tree, prefix: str) -> Dict:
        out = {}
        for name, value in tree.items():
            key = f"{prefix}{name}"
            if isinstance(value, Mapping):
                out[name] = build(value, key + _SEP)
            elif isinstance(value, torch.Tensor):
                out[name] = torch.from_numpy(flat[key]).to(
                    device=value.device, dtype=value.dtype)
            else:
                out[name] = type(value)(flat[key])
        return out

    return build(like, ""), manifest.get("meta", {})


def latest(ckpt_dir: str, prefix: str = "step_") -> Optional[str]:
    """The checkpoint of the highest step in ``ckpt_dir`` (by number)."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix):-len(".npz")]))
    return os.path.join(ckpt_dir, cands[-1])


class AsyncSaver:
    """Background saver with one save in flight. ``submit`` copies the tree
    to the host before the thread starts (a synchronising copy of each
    tensor, never a view of one that the next commit updates in place);
    hashing and writing the file run on the thread. A save that failed
    raises from the next ``wait`` (or ``submit``)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, path: str, tree: Tree, meta: Optional[Dict] = None):
        self.wait()
        args = (path, _flatten(tree), tree_structure_manifest(tree), meta)

        def work():
            try:
                _write(*args)
            except Exception as e:        # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error
