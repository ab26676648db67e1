"""Decoder-only dense transformer: param defs, init, the training
forward and loss, KV cache, and the serving steps — decode, chunked
prefill and speculative verify, each against a dense cache or straight
off a paged pool.

Port of ``repro/models/transformer.py`` for the dense family.  Layer
params are stacked on a leading L axis as in the reference; its ``scan``
over layers becomes a Python loop over that axis.  Serving stores the
parameters once in the compute dtype (the reference keeps float32 and
casts at every use — the same bits, half the memory).  Training keeps
``param_dtype`` (float32) masters; ``lm_loss`` casts the whole tree to
the compute dtype once at its entry, inside autograd, which gives the
bits of the reference's per-use casts and sends float32 gradients to the
masters.  Vocab is padded to a multiple of 256.  MoE is not ported.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (PDef, chunked_cross_entropy,
                                       init_params, mlp_apply, rms_norm,
                                       rms_norm_defs, stack_defs,
                                       swiglu_defs)
from repro_torch.models.remat import resolve_policy, wrap_layer_body

VOCAB_PAD = 256

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


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
         device: torch.device, dtype=None) -> dict:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live there), stored in ``dtype``: by default the compute dtype, as
    serving keeps them; training passes ``param_dtype(cfg)`` for its
    float32 masters."""
    return init_params(model_defs(cfg), generator, device,
                       dtype or compute_dtype(cfg))


def layer_params(params: dict, l: int) -> dict:
    """Views of layer ``l`` of the stacked ``layers`` subtree."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[l]
    return take(params["layers"])


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """The param tree in the compute dtype (a differentiable cast; a
    no-op for leaves already in it)."""
    dt = compute_dtype(cfg)
    if isinstance(params, dict):
        return {k: cast_params(cfg, v) for k, v in params.items()}
    return params.to(dt)


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------

def block_apply(cfg: ArchConfig, params, h, positions):
    """One decoder block. h: (B, S, d) -> (B, S, d).  (The reference also
    returns the MoE aux loss, 0 for the dense family.)"""
    a = attn.attention(
        params["attn"], rms_norm(h, params["attn_norm"]), positions,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        causal=True, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        q_chunk=cfg.q_chunk, scores_dtype=DTYPES[cfg.scores_dtype])
    h = h + a
    return h + mlp_apply(params["mlp"], rms_norm(h, params["mlp_norm"]),
                         cfg.mlp_kind)


def forward(cfg: ArchConfig, params, tokens):
    """tokens (B, S) -> final-normed hidden (B, S, d).  ``params`` are in
    the compute dtype (``lm_loss`` casts them).  Each layer runs under
    the config's remat policy (``models/remat.py``)."""
    _check_family(cfg)
    B, S = tokens.shape
    h = params["embedding"][tokens.long()]
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    def body(h, lp):
        return block_apply(cfg, lp, h, positions)

    body_fn = wrap_layer_body(body, resolve_policy(cfg))
    for l in range(cfg.n_layers):
        h = body_fn(h, layer_params(params, l))
    return rms_norm(h, params["final_norm"])


def lm_loss(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy.  batch: {"tokens": (B, S),
    "labels": (B, S)}; ``params`` in any float dtype (float32 masters in
    training), cast to the compute dtype once here."""
    if "frames" in batch or "patches" in batch:
        raise NotImplementedError(
            "audio frames / vision patches are not ported yet (ROADMAP "
            "A11)")
    params = cast_params(cfg, params)
    h = forward(cfg, params, batch["tokens"])
    labels = batch["labels"]
    return chunked_cross_entropy(
        h, params, labels, chunk=min(cfg.loss_chunk, labels.shape[1]),
        compute_dtype=compute_dtype(cfg))


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

def _decode_layers(cfg: ArchConfig, params, kv_leaves, tokens, attn_body,
                   last=None, all_rows=False):
    """Shared serving skeleton: embed -> layers -> final norm -> logits.
    ``attn_body(layer_params, normed_h, *layer_kv)`` is the pluggable
    attention hook (dense on a per-slot cache view, or the paged kernels
    on the raw pool); ``kv_leaves`` are the stacked (L, ...) cache
    leaves it writes in place, one layer view at a time.

    ``tokens`` (B, C) may carry C >= 1 positions per slot.  ``last`` (B,)
    picks the logits row per slot — a chunk's final REAL token, so a
    padded final chunk still emits the right first token; ``None`` takes
    row 0 (decode).  ``all_rows`` returns logits at every row (B, C,
    vocab_padded) for speculative verify, projected one row at a time so
    each (B, d) @ (d, vocab) product has the decode step's shape."""
    h = params["embedding"][tokens.long()]                # (B, C, d)
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        h = h + attn_body(lp, rms_norm(h, lp["attn_norm"]),
                          *(leaf[l] for leaf in kv_leaves))
        h = h + mlp_apply(lp["mlp"], rms_norm(h, lp["mlp_norm"]),
                          cfg.mlp_kind)
    h = rms_norm(h, params["final_norm"])
    w = params["lm_head"]
    if all_rows:
        return torch.stack([(h[:, j].contiguous() @ w).float()
                            for j in range(h.shape[1])], dim=1)
    if last is None:
        return (h[:, 0] @ w).float()
    b_idx = torch.arange(h.shape[0], device=h.device)
    return (h[b_idx, last.long()] @ w).float()


def _window(start, C: int, horizon: int):
    """Positions (B, C) of a C-token window at ``start`` (B,), clipped to
    ``horizon`` (the padded tail of a final chunk, or a verify window
    past the cache, lands on the last position), and the UNCLIPPED
    lengths ``start + C`` that keep each real row's causal limit exact."""
    pos = start[:, None] + torch.arange(C, device=start.device)[None]
    return pos.clamp(0, horizon - 1), (start + C).to(torch.int32)


def _dense_body(cfg: ArchConfig, attend, positions):
    def attn_body(lp, hn, ck, cv):
        out, _ = attend(
            lp["attn"], hn, {"k": ck, "v": cv}, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
        return out
    return attn_body


def _paged_leaves(pool, scales):
    """The stacked leaves a paged step walks layer by layer: the (k, v)
    pools (L, R, T, KV, dh), plus their (L, R, KV) f32 scales for a
    narrow pool (``scales`` {"k", "v"})."""
    if scales is None:
        return (pool["k"], pool["v"])
    return (pool["k"], pool["v"], scales["k"], scales["v"])


def _paged_result(logits, pool, scales):
    """(logits, pool), or (logits, pool, scales) for a narrow pool."""
    return (logits, pool) if scales is None else (logits, pool, scales)


def _paged_window_body(cfg: ArchConfig, tables, start, positions, lengths,
                       kv_dtype):
    def attn_body(lp, hn, *kvs):
        out, _ = attn.paged_chunk_prefill_attention(
            lp["attn"], hn, kvs, tables, positions, lengths,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            kv_dtype=kv_dtype, start=start)
        return out
    return attn_body


def decode_step(cfg: ArchConfig, params, cache, tokens, positions):
    """One decode step. tokens (B, 1) int; positions (B,) int.  The cache
    ({"k", "v"} of (L, B, S, KV, dh)) is written in place.  Returns
    (logits (B, vocab_padded) float32, cache)."""
    logits = _decode_layers(
        cfg, params, (cache["k"], cache["v"]), tokens,
        _dense_body(cfg, attn.decode_attention, positions))
    return logits, cache


def paged_decode_step(cfg: ArchConfig, params, pool, tables, tokens,
                      positions, scales=None, kv_dtype: str = "bf16"):
    """Gather-free paged decode step (the serving O6 kernel path): each
    layer appends its token's K/V into the slot's active pool block in
    place and runs the paged-decode kernel on the raw pool leaves
    (L, R, T, KV, dh) through the block tables (B, nb) — the dense
    per-slot view is never built.  A narrow pool (``scales`` given, with
    ``kv_dtype`` "int8" or "fp8") re-quantizes each slot's active block
    around the append.  Returns (logits, pool), or (logits, pool,
    scales) for a narrow pool."""

    def attn_body(lp, hn, *kvs):
        out, _ = attn.paged_decode_attention(
            lp["attn"], hn, kvs, tables, positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            kv_dtype=kv_dtype)
        return out

    logits = _decode_layers(cfg, params, _paged_leaves(pool, scales), tokens,
                            attn_body)
    return _paged_result(logits, pool, scales)


def prefill_step(cfg: ArchConfig, params, cache, tokens, start, last):
    """One prompt-chunk step against the dense cache: tokens (B, C) — C
    consecutive prompt tokens per slot from cache position ``start``
    (B,); ``last`` (B,) is the row of the chunk's final real token.
    Returns (logits (B, vocab_padded) at the ``last`` rows, cache written
    in place).  The padded tail of a final chunk rides along at clipped
    positions; its logits rows are never selected."""
    positions, _ = _window(start, tokens.shape[1], cache["k"].shape[2])
    logits = _decode_layers(
        cfg, params, (cache["k"], cache["v"]), tokens,
        _dense_body(cfg, attn.chunk_prefill_attention, positions),
        last=last)
    return logits, cache


def paged_prefill_step(cfg: ArchConfig, params, pool, tables, tokens,
                       start, last, scales=None, kv_dtype: str = "bf16"):
    """Prompt-chunk step straight off the paged block pool: the chunk's
    K/V is scattered into pool blocks through the slot's table and the
    multi-query paged kernel (B2) attends the whole prefix — the dense
    view is never built.  Same contract as :func:`prefill_step` plus the
    tables (and the scales of a narrow pool).  Returns (logits, pool), or
    (logits, pool, scales) for a narrow pool."""
    T = pool["k"].shape[2]
    positions, lengths = _window(start, tokens.shape[1], tables.shape[1] * T)
    logits = _decode_layers(
        cfg, params, _paged_leaves(pool, scales), tokens,
        _paged_window_body(cfg, tables, start, positions, lengths, kv_dtype),
        last=last)
    return _paged_result(logits, pool, scales)


def verify_step(cfg: ArchConfig, params, cache, tokens, start):
    """Speculative-verify step against the dense cache: tokens (B, C) —
    the pending token plus C-1 drafted tokens per slot, written at cache
    positions ``start`` .. ``start + C - 1``.  Returns (logits (B, C,
    vocab_padded) at EVERY row, cache): row j is the target's
    distribution after token j.  Rejected rows' K/V writes land beyond
    the slot's frontier and are rewritten before first unmasked read, so
    rollback is free."""
    positions, _ = _window(start, tokens.shape[1], cache["k"].shape[2])
    logits = _decode_layers(
        cfg, params, (cache["k"], cache["v"]), tokens,
        _dense_body(cfg, attn.chunk_prefill_attention, positions),
        all_rows=True)
    return logits, cache


def paged_verify_step(cfg: ArchConfig, params, pool, tables, tokens, start,
                      scales=None, kv_dtype: str = "bf16"):
    """Speculative-verify step straight off the paged block pool: the
    window's K/V is scattered into pool blocks through the slot's table
    (writes past the reservation land in the NULL block) and the
    multi-query paged kernel (B2) attends the whole prefix.  Same
    all-rows contract as :func:`verify_step`; rejected drafts roll back
    by slot-length truncation — the tables never change, so blocks never
    leak.  Returns (logits, pool), or (logits, pool, scales) for a narrow
    pool."""
    T = pool["k"].shape[2]
    positions, lengths = _window(start, tokens.shape[1], tables.shape[1] * T)
    logits = _decode_layers(
        cfg, params, _paged_leaves(pool, scales), tokens,
        _paged_window_body(cfg, tables, start, positions, lengths, kv_dtype),
        all_rows=True)
    return _paged_result(logits, pool, scales)
