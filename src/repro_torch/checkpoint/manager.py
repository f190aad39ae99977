"""Sharded, atomic, async checkpointing for fault-tolerant training, as
``repro.checkpoint.manager`` has it, on trees of torch tensors.

Layout:  <dir>/step_<N>/shard_<H>.npz   (+ META.json, DONE marker, + LATEST
pointer), the JAX package's exactly, and so are the npz keys: a leaf's key
joins its path's entries with ``//``, ``k:<dict key>``, ``i:<list or tuple
index>`` and ``n:<NamedTuple field>``.  The two packages therefore restore
each other's checkpoints (``TrainState`` and ``AdamWState`` are NamedTuples
of the same fields in both).

* atomic: writes go to ``step_<N>.tmp<H>`` then ``os.rename`` (POSIX-atomic);
  the DONE marker is written only after the shard landed, so a crash
  mid-save never leaves a checkpoint that restores partially.
* async: :meth:`CheckpointManager.save_async` copies every leaf to host
  memory (device to host, synchronised) before it returns and does the
  disk IO on a worker thread; a worker's error surfaces at the next
  :meth:`~CheckpointManager.wait`.

A leaf NumPy cannot hold (bf16) raises ``TypeError`` naming its key: the
train state is f32.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import map_with_path, walk

_SEP = "//"


def _to_host(key: str, leaf) -> np.ndarray:
    """A leaf as a NumPy array of its own (never a view of a tensor)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which "
                            f"NumPy cannot hold; save the f32 state")
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
    return np.array(leaf)


def _flatten(tree) -> dict:
    flat = {}
    for path, leaf in walk(tree):
        key = _SEP.join(path)
        flat[key] = _to_host(key, leaf)
    return flat


def save(directory: str, step: int, tree, shard_id: int = 0,
         n_shards: int = 1) -> str:
    """Blocking save. Returns the finalized checkpoint path."""
    return _write(directory, step, _flatten(tree), shard_id, n_shards)


def _write(directory: str, step: int, flat: dict, shard_id: int = 0,
           n_shards: int = 1) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{shard_id}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"shard_{shard_id}.npz"), **flat)
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump({"step": step, "n_shards": n_shards}, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(final, "DONE"), "w") as f:
        f.write("ok")
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        cand = os.path.join(directory, name)
        if os.path.exists(os.path.join(cand, "DONE")):
            return int(name.split("_")[1])
    # fall back to scanning (LATEST pointer lost)
    best = None
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(directory, name, "DONE")):
                s = int(m.group(1))
                best = s if best is None else max(best, s)
    return best


def _from_host(arr: np.ndarray, leaf):
    """``arr`` in the dtype, shape and device of ``leaf`` (a tensor, or a
    NumPy array)."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return torch.from_numpy(arr.astype(dt, copy=False).reshape(
            tuple(leaf.shape))).to(leaf.device)
    if hasattr(leaf, "dtype"):
        return arr.astype(leaf.dtype).reshape(leaf.shape)
    return arr


def restore(directory: str, like, step: Optional[int] = None,
            shard_id: int = 0) -> Tuple[int, Any]:
    """Restore into the structure of ``like`` (each leaf's dtype, shape
    and device). Returns (step, tree)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "DONE")):
        raise FileNotFoundError(f"checkpoint {path} incomplete (no DONE)")
    with np.load(os.path.join(path, f"shard_{shard_id}.npz")) as data:
        tree = map_with_path(lambda p, leaf: _from_host(
            data[_SEP.join(p)], leaf), like)
    return step, tree


class CheckpointManager:
    """Async manager with keep-last-N retention and restart discovery."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree):
        """Snapshot ``tree`` to host memory now; write it on a worker."""
        self.wait()
        flat = _flatten(tree)

        def work():
            try:
                _write(self.directory, step, flat)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_blocking(self, step: int, tree):
        self.wait()
        save(self.directory, step, tree)
        self._gc()

    def restore_latest(self, like):
        self.wait()
        return restore(self.directory, like)

    def latest_step(self):
        return latest_step(self.directory)

    def _gc(self):
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "DONE")):
                steps.append(int(m.group(1)))
        for s in sorted(steps)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
