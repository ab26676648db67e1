"""Checkpointing for one device: per-leaf files, async writer, rotation
(port of ``repro/checkpoint/sharded.py``).

Layout of one checkpoint directory::

    step_000123/
      MANIFEST.json     tree structure: per-leaf file, shape, dtype; step
      <leaf>.npy        one file per leaf (its path joined by ".")

The port's own format: one device holds every leaf whole, so there are
no shard files (the reference writes one file per distinct shard).
bfloat16 leaves, which numpy cannot hold, are stored as their 16-bit
patterns and the manifest names their dtype.

  * **Atomic**: written into ``<dir>.tmp`` then renamed — a crash mid-save
    never corrupts the latest checkpoint.
  * **Async**: ``save_async`` copies every leaf to host memory before it
    returns and writes the files on a worker thread, so training may
    overwrite its tensors while the IO drains.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.tree import from_leaves, leaves

SEP = "."
# Leaf dtypes a training state holds: f32 masters and moments (bf16 with
# moment_dtype="bfloat16"), the int32 step.
_DTYPES = ("float32", "bfloat16", "int32")


def _flatten(tree):
    """(key, leaf) pairs of a nested dict, keys sorted and joined by SEP."""
    return [(SEP.join(map(str, path)), leaf) for path, leaf in leaves(tree)]


def _unflatten(pairs) -> dict:
    return from_leaves((tuple(key.split(SEP)), leaf) for key, leaf in pairs)


def _dtype_name(t: torch.Tensor) -> str:
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise TypeError(f"checkpoint leaf of dtype {t.dtype} (supported: "
                        f"{_DTYPES})")
    return name


def save_checkpoint(path: str, tree, *, step: int, extra: dict = None):
    """Synchronous save (atomic via tmp + rename)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(tree):
        t = leaf.detach().cpu()
        name = _dtype_name(t)
        data = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        fname = f"{key}.npy"
        np.save(os.path.join(tmp, fname), data.numpy())
        manifest["leaves"][key] = {"file": fname, "shape": list(t.shape),
                                   "dtype": name}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


def load_checkpoint(path: str, target_tree, *, device=None):
    """Restore into the structure of ``target_tree`` (tensors, or "meta"
    tensors that hold only shapes): each leaf lands on ``device``, or on
    its target leaf's device when ``device`` is None, in the dtype it was
    saved in.  Raises KeyError for a leaf the checkpoint lacks and
    ValueError for a shape that differs.  Returns (tree, step, extra)."""
    manifest = load_manifest(path)
    out = []
    for key, target in _flatten(target_tree):
        rec = manifest["leaves"].get(key)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        shape = tuple(rec["shape"])
        if tuple(target.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {shape} != target "
                             f"{tuple(target.shape)}")
        t = torch.from_numpy(np.load(os.path.join(path, rec["file"])))
        if rec["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append((key, t.to(target.device if device is None
                              else device)))
    return _unflatten(out), manifest["step"], manifest.get("extra", {})


class CheckpointManager:
    """Rotating async checkpoint writer.

    ``save_async`` snapshots the tree to host memory synchronously and
    writes files on a worker thread; ``wait()`` drains.  Keeps the
    ``keep`` newest checkpoints; ``latest()``/``restore_latest`` find
    them.
    """

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._lock = threading.Lock()
        self._pending: list = []

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save_async(self, tree, *, step: int, extra: dict = None) -> Future:
        # Snapshot to host NOW so training can overwrite its tensors.
        host = _unflatten([(k, v.detach().to("cpu", copy=True))
                           for k, v in _flatten(tree)])
        fut = self._pool.submit(self._save_and_gc, host, step, extra)
        with self._lock:
            self._pending.append(fut)
        return fut

    def _save_and_gc(self, host_tree, step, extra):
        path = save_checkpoint(self._dir(step), host_tree, step=step,
                               extra=extra)
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
        return path

    def all_steps(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest(self):
        steps = self.all_steps()
        return self._dir(steps[-1]) if steps else None

    def restore_latest(self, target_tree, *, device=None):
        path = self.latest()
        if path is None:
            return None
        return load_checkpoint(path, target_tree, device=device)

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)
