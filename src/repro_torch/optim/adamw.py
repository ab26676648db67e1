"""AdamW + schedule + clipping (port of ``repro/optim/adamw.py``).

``update`` writes the new values into the params, moments and
gradients it is given, leaf by leaf, with the reference's arithmetic in
its order: the counterpart of the reference's train step, whose ``jit``
donates params and optimizer state.  A functional update would hold a
second copy of params and moments while the first is alive (37 GB for
rwkv6-3b's 3.1e9 float32 params, which then does not fit one 80 GB
card); this one holds a few temporaries of one leaf.  Every leaf's math
runs in float32; moments are stored in ``moment_dtype``.  Trees are nested dicts
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


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step, written into ``params``, ``state``'s moments and
    ``grads`` (clipped) one leaf at a time.  Returns (params, new_state,
    metrics): the same param and moment tensors, a new step count."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, mu, nu):
        g.mul_(scale)
        g32 = g.to(torch.float32)
        mu32 = mu.to(torch.float32).mul_(b1).add_((1 - b1) * g32)
        nu32 = nu.to(torch.float32).mul_(b2).add_(
            ((1 - b2) * g32).mul_(g32))
        p32 = p.to(torch.float32)
        denom = (nu32 / bc2).sqrt_().add_(cfg.eps)
        step_ = (mu32 / bc1).div_(denom)
        del denom
        step_.add_(cfg.weight_decay * p32).mul_(lr)
        p32.sub_(step_)
        for dst, src in ((p, p32), (mu, mu32), (nu, nu32)):
            if dst is not src:
                dst.copy_(src)

    map_tree(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
