"""Step construction: the training step (port of the ``build_train`` half
of ``repro/launch/steps.py`` for one device — no mesh, no sharder).

``build_train`` returns the model, the f32 param and optimizer-state
initialisers and ``train_step(params, opt, batch) -> (params, opt,
metrics)``: the loss and its gradients (accumulated over ``microbatch``
slices of the batch in an f32 accumulator when ``cfg.microbatch > 1``),
then ``adamw.update``.  The step updates ``params`` and ``opt`` in place
and returns them: the reference's jitted step donates both
(``donate_argnums=(0, 1)``), and a second copy of them does not fit one
card for rwkv6-3b.  A caller that needs its inputs afterwards passes
copies, as the reference's own tests do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import get_model
from repro_torch.models.transformer import param_dtype
from repro_torch.optim import adamw
from repro_torch.tree import from_leaves, leaves


@dataclasses.dataclass
class TrainArtifacts:
    cfg: ArchConfig
    shape: ShapeConfig
    model: Any
    adamw_cfg: adamw.AdamWConfig
    # (params, opt, batch) -> (params, opt, metrics)
    step_fn: Callable
    init_params: Callable        # (generator) -> f32 master params
    init_opt: Callable           # (params) -> AdamW state


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: gradients in each
    param's dtype, the same tree structure."""
    paths, values = zip(*leaves(params))
    values = [p.detach().requires_grad_() for p in values]
    with torch.enable_grad():
        loss = loss_fn(from_leaves(zip(paths, values)), batch)
        grads = torch.autograd.grad(loss, values)
    return loss.detach(), from_leaves(zip(paths, grads))


def build_train(cfg: ArchConfig, shape: ShapeConfig, *,
                adamw_cfg: adamw.AdamWConfig = None,
                device=None) -> TrainArtifacts:
    """The training step of one cell on one device (``None`` = CUDA)."""
    model = get_model(cfg, device=device)
    acfg = adamw_cfg or adamw.AdamWConfig()
    M = cfg.microbatch

    def train_step(params, opt, batch):
        if M and M > 1:
            # Gradient accumulation over M microbatches, f32 accumulator:
            # bounds activation memory to one microbatch.
            B = batch["tokens"].shape[0]
            if B % M:
                raise ValueError(f"global batch {B} does not split into "
                                 f"{M} microbatches")
            acc = {path: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                   for path, p in leaves(params)}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(M):
                sl = slice(i * (B // M), (i + 1) * (B // M))
                l, g = value_and_grad(model.loss, params,
                                      {k: v[sl] for k, v in batch.items()})
                for path, gi in leaves(g):
                    acc[path].add_(gi.float() / M)
                loss = loss + l / M
            grads = from_leaves((path, acc[path].to(p.dtype))
                                for path, p in leaves(params))
        else:
            loss, grads = value_and_grad(model.loss, params, batch)
        new_p, new_opt, metrics = adamw.update(acfg, grads, opt, params)
        metrics["loss"] = loss
        return new_p, new_opt, metrics

    return TrainArtifacts(
        cfg=cfg, shape=shape, model=model, adamw_cfg=acfg,
        step_fn=train_step,
        init_params=lambda generator: model.init(generator,
                                                 dtype=param_dtype(cfg)),
        init_opt=lambda params: adamw.init_state(acfg, params))
