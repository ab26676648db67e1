"""Carry a JAX param tree into the port.

``params_from_jax`` takes the tree the reference's ``init(cfg, rng)``
returns, with every leaf already converted to a numpy array (the caller
owns the framework boundary — this package never imports JAX), and
returns the port's tree: same keys, same shapes, each leaf a tensor on
``device`` in ``dtype``.  Rounding a float32 JAX leaf to bf16 here gives
the bits the reference's per-use ``.astype(bf16)`` gives.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree, *, device=None, dtype=torch.float32) -> dict:
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.kind != "f":
            raise TypeError(f"param leaf of dtype {arr.dtype}; want float")
        return torch.tensor(arr.astype(np.float32, copy=False)).to(
            device=dev, dtype=dtype)

    return conv(tree)
