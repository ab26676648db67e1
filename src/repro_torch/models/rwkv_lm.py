"""RWKV-6 language model: an attention-free stack of time-mix and
channel-mix blocks (port of the training half of
``repro/models/rwkv_lm.py``).

Layer params are stacked on a leading L axis as in the reference; its
``scan`` over layers becomes a Python loop, each layer under the
config's remat policy (``models/remat.py``: under "full" the backward
runs a layer's forward again, so B4 launches twice a layer a step).
``lm_loss`` casts the float32 masters to the compute dtype once at its
entry, as ``transformer.lm_loss`` does.  The decode, cache, paged and
prefill steps wait for ROADMAP A11 (rest).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6
from repro_torch.models.layers import (PDef, chunked_cross_entropy,
                                       init_params, rms_norm, rms_norm_defs,
                                       stack_defs)
from repro_torch.models.remat import resolve_policy, wrap_layer_body
from repro_torch.models.transformer import (cast_params, compute_dtype,
                                            layer_params, padded_vocab)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name}: rwkv_lm runs the ssm family, not "
                         f"{cfg.family!r}")


def model_defs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    block = {
        "tm": rwkv6.rwkv6_time_mix_defs(d, cfg.rwkv_head_dim),
        "cm": rwkv6.rwkv6_channel_mix_defs(d, cfg.d_ff),
    }
    return {
        "embedding": PDef((padded_vocab(cfg.vocab), d), "small"),
        "lm_head": PDef((d, padded_vocab(cfg.vocab))),
        "final_norm": rms_norm_defs(d),
        "layers": stack_defs(block, cfg.n_layers),
    }


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device, dtype=None) -> dict:
    """Random weights drawn on ``device`` from ``generator`` in ``dtype``
    (default the compute dtype; training passes float32 for its
    masters)."""
    return init_params(model_defs(cfg), generator, device,
                       dtype or compute_dtype(cfg))


def forward(cfg: ArchConfig, params, tokens):
    """tokens (B, S) -> final-normed hidden (B, S, d).  ``params`` are in
    the compute dtype (``lm_loss`` casts them)."""
    _check_family(cfg)
    h = params["embedding"][tokens.long()]

    def body(h, lp):
        out, _ = rwkv6.time_mix_apply(lp["tm"], h,
                                      head_dim=cfg.rwkv_head_dim)
        h = h + out
        out, _ = rwkv6.channel_mix_apply(lp["cm"], h)
        return h + out

    body_fn = wrap_layer_body(body, resolve_policy(cfg))
    for l in range(cfg.n_layers):
        h = body_fn(h, layer_params(params, l))
    return rms_norm(h, params["final_norm"])


def lm_loss(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy.  batch: {"tokens": (B, S),
    "labels": (B, S)}; ``params`` in any float dtype, cast to the compute
    dtype once here."""
    params = cast_params(cfg, params)
    h = forward(cfg, params, batch["tokens"])
    labels = batch["labels"]
    return chunked_cross_entropy(
        h, params, labels, chunk=min(cfg.loss_chunk, labels.shape[1]),
        compute_dtype=compute_dtype(cfg))
