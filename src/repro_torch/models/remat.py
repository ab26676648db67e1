"""Remat policy knob — the activation-checkpoint lever (port of
``repro/models/remat.py``).

  "full" — per-layer ``torch.utils.checkpoint`` (non-reentrant): only the
           layer's inputs are kept, and the backward runs the layer's
           forward again (so a checkpointed layer launches its attention
           kernel twice per step)
  "none" — no outer checkpoint (the attention backward still recomputes
           its scores one query chunk at a time)
  "dots" — the reference's ``checkpoint_dots_with_no_batch_dims``; not
           ported yet (ROADMAP A14)
"""

from __future__ import annotations

import torch.utils.checkpoint


def wrap_layer_body(body, policy):
    """Apply the configured checkpoint policy to a layer body."""
    if policy in (False, None, "none"):
        return body
    if policy in (True, "full"):
        def checkpointed(*args):
            return torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False)
        return checkpointed
    if policy == "dots":
        raise NotImplementedError(
            "remat policy 'dots' is not ported yet (ROADMAP A14)")
    raise ValueError(f"unknown remat policy {policy!r}")


def resolve_policy(cfg):
    """ArchConfig -> policy value (remat_policy overrides legacy remat)."""
    if cfg.remat_policy:
        return cfg.remat_policy
    return "full" if cfg.remat else "none"
