#!/usr/bin/env python3
"""Step-0 loss and gradient norm of smollm-360m at its published widths
and a reduced depth: the JAX reference and the PyTorch port on the same
weights (the reference's ``init``, carried over by ``bridge``), on the
CPU in float32.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/grad_by_depth.py \\
        --layers 2 4 8 --seq 128

Shows how the reference's initialiser makes the gradient grow with depth
and how far two float32 evaluations of the same model (JAX's and the
port's) part: the largest per-leaf difference, relative to the leaf's
largest gradient.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_config
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import get_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.optim import adamw
from repro_torch.tree import leaves


def one_depth(n_layers: int, seq: int, seed: int) -> dict:
    over = dict(n_layers=n_layers, compute_dtype="float32", q_chunk=64,
                loss_chunk=64)
    jm = jax_get_model(dataclasses.replace(jax_config("smollm-360m"),
                                           **over))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = get_model(dataclasses.replace(get_config("smollm-360m"), **over),
                   device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(seed)
    tok = r.integers(0, tm.cfg.vocab, (1, seq)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = value_and_grad(tm.loss, tp, {k: torch.tensor(v)
                                          for k, v in batch.items()})
    jflat = dict(leaves(jax.tree.map(np.asarray, jg)))
    part = max(float(np.abs(jflat[p] - g.numpy()).max()
                     / np.abs(jflat[p]).max()) for p, g in leaves(tg))
    return {"layers": n_layers, "loss_jax": float(jl), "loss_port": float(tl),
            "grad_norm_jax": float(jax_adamw.global_norm(jg)),
            "grad_norm_port": float(adamw.global_norm(tg)),
            "max_leaf_rel_diff": part}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print("| layers | loss JAX | loss port | grad_norm JAX | grad_norm port "
          "| max leaf |JAX - port| / max |g| |")
    print("| --- | --- | --- | --- | --- | --- |")
    for n in args.layers:
        r = one_depth(n, args.seq, args.seed)
        print(f"| {n} | {r['loss_jax']:.6f} | {r['loss_port']:.6f} | "
              f"{r['grad_norm_jax']:.6g} | {r['grad_norm_port']:.6g} | "
              f"{r['max_leaf_rel_diff']:.3g} |", flush=True)


if __name__ == "__main__":
    main()
