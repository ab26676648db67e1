"""RWKV-6 language model: an attention-free stack of time-mix and
channel-mix blocks (port of ``repro/models/rwkv_lm.py``): the training
loss and the serving steps.

Layer params are stacked on a leading L axis as in the reference; its
``scan`` over layers becomes a Python loop, each layer under the
config's remat policy (``models/remat.py``: under "full" the backward
runs a layer's forward again, so B4 launches twice a layer a step).
``lm_loss`` casts the float32 masters to the compute dtype once at its
entry, as ``transformer.lm_loss`` does.

Serving carries, per layer, the f32 WKV state and the two token-shift
slots (the last time-mix and channel-mix inputs, in the cache dtype):
O(1) per slot whatever the sequence length.  The decode step is the
single-step update in plain torch (no kernel, as in the reference); the
paged step (``model_zoo``) runs it on the slots' state rows and the
chunked prefill over the chunk (both in ``models/scan_prefill``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6
from repro_torch.models.layers import (PDef, chunked_cross_entropy,
                                       init_params, rms_norm, rms_norm_defs,
                                       stack_defs)
from repro_torch.models.remat import resolve_policy, wrap_layer_body
from repro_torch.models.scan_prefill import batch_axes_of, scan_prefill
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


# ---------------------------------------------------------------------------
# Serving: the carried state (wkv matrix + two token-shift slots per layer)
# ---------------------------------------------------------------------------

def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)}: ``wkv`` (L, B, H, N, N) f32, ``tm_prev``
    and ``cm_prev`` (L, B, d) in the cache dtype.  ``max_seq`` is unused
    (the state does not grow) but kept for API parity."""
    d, N = cfg.d_model, cfg.rwkv_head_dim
    L = cfg.n_layers
    return {"wkv": ((L, batch, d // N, N, N), torch.float32),
            "tm_prev": ((L, batch, d), dtype),
            "cm_prev": ((L, batch, d), dtype)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16) -> dict:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_spec(cfg, batch, max_seq,
                                                dtype).items()}


def cache_axes(cfg: ArchConfig) -> dict:
    return {"wkv": ("layers", "batch", "heads", None, None),
            "tm_prev": ("layers", "batch", None),
            "cm_prev": ("layers", "batch", None)}


def _decode(cfg: ArchConfig, params, cache, tokens, out) -> torch.Tensor:
    """The single-token decode body: reads layer ``l`` of ``cache`` and
    writes its new state into layer ``l`` of ``out`` (``cache`` itself
    for an in-place step).  Returns the logits (B, vocab_padded) f32."""
    _check_family(cfg)
    h = params["embedding"][tokens.long()]                    # (B, 1, d)
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        o, (wkv, tm_last) = rwkv6.time_mix_apply(
            lp["tm"], h, head_dim=cfg.rwkv_head_dim, state=cache["wkv"][l],
            x_prev=cache["tm_prev"][l], decode=True)
        h = h + o
        o, cm_last = rwkv6.channel_mix_apply(lp["cm"], h,
                                             x_prev=cache["cm_prev"][l])
        h = h + o
        out["wkv"][l].copy_(wkv)
        out["tm_prev"][l].copy_(tm_last)
        out["cm_prev"][l].copy_(cm_last)
    h = rms_norm(h, params["final_norm"])
    return (h[:, 0] @ params["lm_head"]).float()


def decode_step(cfg: ArchConfig, params, cache, tokens, positions):
    """One decode step.  tokens (B, 1); ``positions`` unused (the state
    carries the history) but kept for API parity.  The cache is written
    in place.  Returns (logits (B, vocab_padded) f32, cache)."""
    return _decode(cfg, params, cache, tokens, cache), cache



def prefill_step(cfg: ArchConfig, params, cache, tokens, start, last):
    """Chunked prefill by running the decode body over the chunk:
    bit-identical to C one-token steps, each slot frozen past ``last`` so
    pad feeds never reach its wkv or token-shift state.  The cache is
    written in place.  Returns (logits (B, vocab_padded) at the ``last``
    rows, cache)."""
    def step(c, tok, pos):
        new = {name: torch.empty_like(leaf) for name, leaf in c.items()}
        return _decode(cfg, params, c, tok, new), new

    return scan_prefill(step, cache, tokens, start, last,
                        logits_width=padded_vocab(cfg.vocab),
                        batch_axes=batch_axes_of(cache_axes(cfg)))
