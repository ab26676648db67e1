"""AdamW + schedule + clipping (port of ``repro/optim/adamw.py``).

Functional, as the reference: ``update`` returns new param and state
trees and leaves its inputs untouched.  Every leaf's math runs in
float32; moments are stored in ``moment_dtype``.  Trees are nested dicts
walked in sorted-key order, the reference's pytree order, so the global
norm sums its per-leaf terms in the same order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, map_tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to 10%; ``step`` an int tensor, the
    result a float32 scalar tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_state(cfg: AdamWConfig, params) -> dict:
    dt = _DTYPES[cfg.moment_dtype]
    dev = leaves(params)[0][1].device
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {
        "mu": map_tree(z, params),
        "nu": map_tree(z, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree):
    terms = [torch.sum(torch.square(x.to(torch.float32)))
             for _, x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(terms)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return map_tree(lambda g: (g * scale).to(g.dtype), tree), norm


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    mdt = _DTYPES[cfg.moment_dtype]

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32)
        mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g32
        nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g32 * g32
        mhat = mu32 / bc1
        nhat = nu32 / bc2
        p32 = p.to(torch.float32)
        step_ = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32
        return ((p32 - lr * step_).to(p.dtype), mu32.to(mdt),
                nu32.to(mdt))

    out = map_tree(upd, params, grads, state["mu"], state["nu"])
    new_p, new_mu, new_nu = (map_tree(lambda t, i=i: t[i], out)
                             for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
