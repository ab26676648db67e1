"""Carry a JAX param tree and AdamW state into the port.

``params_from_jax`` takes the tree the reference's ``init(cfg, rng)``
returns, with every leaf already converted to a numpy array (the caller
owns the framework boundary — this package never imports JAX), and
returns the port's tree: same keys, same shapes, each leaf a tensor on
``device`` in ``dtype``.  Rounding a float32 JAX leaf to bf16 here gives
the bits the reference's per-use ``.astype(bf16)`` gives.
``opt_state_from_jax`` does the same for the reference's
``adamw.init_state``/``update`` state: ``mu`` and ``nu`` trees and the
``step`` count, as numpy.
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


def opt_state_from_jax(state, *, device=None) -> dict:
    """The reference's AdamW state ({"mu": tree, "nu": tree, "step":
    scalar}, leaves as numpy) as the port's: float32 moment trees and an
    int32 step, on ``device``."""
    dev = resolve_device(device)
    mu = params_from_jax(state["mu"], device=dev)
    nu = params_from_jax(state["nu"], device=dev)
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=dev)
    return {"mu": mu, "nu": nu, "step": step}
