"""Decoder-only dense transformer: param defs, init, KV cache, decode.

Port of the decode half of ``repro/models/transformer.py`` for the dense
family.  Layer params are stacked on a leading L axis as in the
reference; its ``scan`` over layers becomes a Python loop over that
axis.  Parameters are stored once in the compute dtype (the reference
keeps float32 and casts at every use — the same bits, half the memory).
Vocab is padded to a multiple of 256.  MoE is not in this slice.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (PDef, init_params, mlp_apply,
                                       rms_norm, rms_norm_defs, stack_defs,
                                       swiglu_defs)

VOCAB_PAD = 256

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (family "
            f"{cfg.family!r}, n_experts {cfg.n_experts}; ROADMAP A12)")


# ---------------------------------------------------------------------------
# Param defs + init
# ---------------------------------------------------------------------------

def block_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": rms_norm_defs(d),
        "attn": attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.qk_norm),
        "mlp_norm": rms_norm_defs(d),
        "mlp": swiglu_defs(d, cfg.d_ff),
    }


def model_defs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    vp = padded_vocab(cfg.vocab)
    return {
        "embedding": PDef((vp, cfg.d_model), "small"),
        "lm_head": PDef((cfg.d_model, vp)),
        "final_norm": rms_norm_defs(cfg.d_model),
        "layers": stack_defs(block_defs(cfg), cfg.n_layers),
    }


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device) -> dict:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live there), stored in the compute dtype."""
    return init_params(model_defs(cfg), generator, device,
                       compute_dtype(cfg))


def layer_params(params: dict, l: int) -> dict:
    """Views of layer ``l`` of the stacked ``layers`` subtree."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[l]
    return take(params["layers"])


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16) -> dict:
    """{"k", "v"}: (shape, dtype) of the stacked (L, B, S, KV, dh) cache."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16) -> dict:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_spec(cfg, batch, max_seq,
                                                dtype).items()}


def cache_axes(cfg: ArchConfig) -> dict:
    ax = ("layers", "batch", "kv_seq", "kv", None)
    return {"k": ax, "v": ax}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_layers(cfg: ArchConfig, params, kv_leaves, tokens, attn_body):
    """Shared decode skeleton: embed -> layers -> final norm -> logits.
    ``attn_body(layer_params, normed_h, *layer_kv)`` is the pluggable
    decode-attention hook (dense on a per-slot cache view, or the paged
    kernel on the raw pool); ``kv_leaves`` are the stacked (L, ...) cache
    leaves it writes in place, one layer view at a time."""
    h = params["embedding"][tokens.long()]                # (B, 1, d)
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        h = h + attn_body(lp, rms_norm(h, lp["attn_norm"]),
                          *(leaf[l] for leaf in kv_leaves))
        h = h + mlp_apply(lp["mlp"], rms_norm(h, lp["mlp_norm"]),
                          cfg.mlp_kind)
    h = rms_norm(h, params["final_norm"])
    return (h[:, 0] @ params["lm_head"]).float()


def decode_step(cfg: ArchConfig, params, cache, tokens, positions):
    """One decode step. tokens (B, 1) int; positions (B,) int.  The cache
    ({"k", "v"} of (L, B, S, KV, dh)) is written in place.  Returns
    (logits (B, vocab_padded) float32, cache)."""

    def attn_body(lp, hn, ck, cv):
        out, _ = attn.decode_attention(
            lp["attn"], hn, {"k": ck, "v": cv}, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
        return out

    logits = _decode_layers(cfg, params, (cache["k"], cache["v"]), tokens,
                            attn_body)
    return logits, cache


def paged_decode_step(cfg: ArchConfig, params, pool, tables, tokens,
                      positions, kv_dtype: str = "bf16"):
    """Gather-free paged decode step (the serving O6 kernel path): each
    layer appends its token's K/V into the slot's active pool block in
    place and runs the paged-decode kernel on the raw pool leaves
    (L, R, T, KV, dh) through the block tables (B, nb) — the dense
    per-slot view is never built.  Returns (logits, pool)."""

    def attn_body(lp, hn, ck, cv):
        out, _ = attn.paged_decode_attention(
            lp["attn"], hn, (ck, cv), tables, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            kv_dtype=kv_dtype)
        return out

    logits = _decode_layers(cfg, params, (pool["k"], pool["v"]), tokens,
                            attn_body)
    return logits, pool
