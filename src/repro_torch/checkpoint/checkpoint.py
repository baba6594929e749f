"""Checkpoints in the JAX package's on-disk layout (port of
``repro.checkpoint.checkpoint``).

A checkpoint is ``<dir>/step_XXXXXXXXXX/`` holding ``arrays.npz`` and
``manifest.json``.  The tree is a nested dict whose leaves are numpy arrays
or tensors; its keys are the ``/``-joined paths of the leaves (the JAX
tree paths, e.g. ``params/layers/scan/pos0/mixer/sparse/wq``), each with
its file name, shape, dtype and the sha1 of its bytes in the manifest.
Writes are atomic (``tmp.<step>.<pid>`` then ``os.rename``) and keep the
last ``keep_last`` steps.  ``AsyncCheckpointer`` copies the tree to host
memory synchronously and writes on a background thread.

The trainer maps between this layout and the port's modules with
``repro_torch.convert`` (``train_state_to_jax`` / ``train_state_from_jax``),
so a checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A host copy: the caller may change ``x`` in place once ``save``
    returns (a numpy leaf can be a view of a live CPU tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for name, sub in tree.items():
        key = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(sub, dict):
            out.update(flatten(sub, key))
        else:
            out[key] = sub
    return out


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _sha1(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def save(ckpt_dir: str, step: int, tree: dict, *, keep_last: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _host(v) for k, v in flatten(tree).items()}
    manifest = {"step": step, "time": time.time(),
                "extra": extra_meta or {}, "arrays": {}}
    arrays = {}
    for i, (key, arr) in enumerate(sorted(flat.items())):
        name = f"a{i}"
        arrays[name] = arr
        manifest["arrays"][key] = {"file": name, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype),
                                   "sha1": _sha1(arr)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, *, step: Optional[int] = None,
            verify: bool = True):
    """Read a checkpoint (the latest by default).  Returns (nested dict of
    numpy arrays, the manifest's ``extra``).  Raises on a checksum
    mismatch when ``verify``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        for key, meta in manifest["arrays"].items():
            arr = npz[meta["file"]]
            if verify and _sha1(arr) != meta["sha1"]:
                raise IOError(f"checksum mismatch for {key} in {path}")
            flat[key] = arr
    return unflatten(flat), manifest.get("extra", {})


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, persist on a background
    thread; one save in flight at a time, and ``wait`` raises a failed
    write's error."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra_meta: Optional[dict] = None):
        self.wait()
        host_tree = unflatten({k: _host(v) for k, v in flatten(tree).items()})

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, keep_last=self.keep_last,
                     extra_meta=extra_meta)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
