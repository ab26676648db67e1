"""Whisper-style encoder-decoder backbone, conv frontend stubbed (port of
``repro/models/encdec.py``).

As in the reference, the modality frontend is a stub: the encoder takes
precomputed frame embeddings (B, S_enc, d_model) (``model_zoo.
input_specs`` gives a training batch its ``frames``).  The backbone is a
bidirectional encoder and a causal decoder with cross-attention; both
attend through kernel B3 (``attention.attention``), the encoder and the
cross-attention without a mask.  Layer params are stacked on a leading
axis (``encoder``, ``decoder``) and looped over in Python.

The serving cache is flat and name-keyed like the other families': the
decoder's self-attention ``k`` / ``v`` (L, B, max_seq, KV, dh) and the
cross-attention's ``cross_k`` / ``cross_v`` (L, B, S_enc, KV, dh), with
``S_enc = max_seq`` (the reference's ``enc_len or max_seq``, which every
caller leaves at ``max_seq``).  The reference nests the same leaves as
``{"self_kv": {k, v}, "cross_kv": {k, v}}``.  The cross leaves are
read-only: written once (``build_cross_cache``, put in through the
engine's insert door) and never by a step.  ``cache_axes`` says so with
their ``enc_seq`` axis: at O6 a leaf without a ``kv_seq`` axis lives in
the paged manager's state rows, and one with ``enc_seq`` is never
written back (``serving/paged``), so the cross K/V is never
block-paged and never quantized, and the self K/V lives in blocks; the
paged decode step takes both the block tables and the rows.

Two cross paths, copied as the reference has them (ROADMAP C12):
``decode_full`` ropes the cross keys at the encoder positions, while
``build_cross_cache`` does not rope them and rounds K/V to bf16, and the
cross ``decode_attention`` ropes q only.  The two therefore part; each
is held to its own reference counterpart, never one to the other.
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
from repro_torch.models.scan_prefill import (batch_axes_of, gather_rows,
                                             scan_prefill)
from repro_torch.models.transformer import (DTYPES, cast_params,
                                            compute_dtype, padded_vocab)

SELF = ("k", "v")
CROSS = ("cross_k", "cross_v")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "audio" or not cfg.is_encdec:
        raise ValueError(f"{cfg.name}: encdec runs the audio family with "
                         f"an encoder, not {cfg.family!r} with "
                         f"n_enc_layers {cfg.n_enc_layers}")


def _layer(tree: dict, l: int) -> dict:
    """Views of layer ``l`` of a stacked subtree."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _enc_block_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": rms_norm_defs(d),
        "attn": attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "mlp_norm": rms_norm_defs(d),
        "mlp": swiglu_defs(d, cfg.d_ff),
    }


def _dec_block_defs(cfg: ArchConfig) -> dict:
    defs = _enc_block_defs(cfg)
    defs["cross_norm"] = rms_norm_defs(cfg.d_model)
    defs["cross"] = attn.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim)
    return defs


def model_defs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    vp = padded_vocab(cfg.vocab)
    return {
        "embedding": PDef((vp, cfg.d_model), "small"),
        "lm_head": PDef((cfg.d_model, vp)),
        "enc_norm": rms_norm_defs(cfg.d_model),
        "final_norm": rms_norm_defs(cfg.d_model),
        "encoder": stack_defs(_enc_block_defs(cfg), cfg.n_enc_layers),
        "decoder": stack_defs(_dec_block_defs(cfg), cfg.n_layers),
    }


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device, dtype=None) -> dict:
    """Random weights drawn on ``device`` from ``generator``, stored in
    ``dtype`` (default the compute dtype, as serving keeps them)."""
    return init_params(model_defs(cfg), generator, device,
                       dtype or compute_dtype(cfg))


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------

def _mlp(cfg: ArchConfig, lp, h):
    return mlp_apply(lp["mlp"], rms_norm(h, lp["mlp_norm"]), cfg.mlp_kind)


def encode(cfg: ArchConfig, params, frames):
    """frames (B, S_enc, d) precomputed embeddings -> encoder states (B,
    S_enc, d), bidirectional (B3 without a mask).  ``params`` in the
    compute dtype; each layer runs under the config's remat policy."""
    _check_family(cfg)
    h = frames.to(compute_dtype(cfg))
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)

    def body(h, lp):
        h = h + attn.attention(
            lp["attn"], rms_norm(h, lp["attn_norm"]), positions,
            causal=False, q_chunk=cfg.q_chunk,
            scores_dtype=DTYPES[cfg.scores_dtype], **_attn_kw(cfg))
        return h + _mlp(cfg, lp, h)

    body_fn = wrap_layer_body(body, resolve_policy(cfg))
    for l in range(cfg.n_enc_layers):
        h = body_fn(h, _layer(params["encoder"], l))
    return rms_norm(h, params["enc_norm"])


def decode_full(cfg: ArchConfig, params, tokens, enc_h):
    """The teacher-forced decoder pass: tokens (B, S_dec) against encoder
    states ``enc_h`` (B, S_enc, d) -> final-normed hidden (B, S_dec, d).
    The cross keys are roped at the encoder positions (C12)."""
    _check_family(cfg)
    h = params["embedding"][tokens.long()]
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    Se = enc_h.shape[1]
    enc_pos = torch.arange(Se, device=h.device)[None].expand(B, Se)

    def body(h, lp, enc_h):
        h = h + attn.attention(
            lp["attn"], rms_norm(h, lp["attn_norm"]), positions,
            causal=True, q_chunk=cfg.q_chunk,
            scores_dtype=DTYPES[cfg.scores_dtype], **_attn_kw(cfg))
        h = h + attn.attention(
            lp["cross"], rms_norm(h, lp["cross_norm"]), positions,
            causal=False, q_chunk=cfg.q_chunk, kv_x=enc_h,
            kv_positions=enc_pos, scores_dtype=DTYPES[cfg.scores_dtype],
            **_attn_kw(cfg))
        return h + _mlp(cfg, lp, h)

    body_fn = wrap_layer_body(body, resolve_policy(cfg))
    for l in range(cfg.n_layers):
        h = body_fn(h, _layer(params["decoder"], l), enc_h)
    return rms_norm(h, params["final_norm"])


def lm_loss(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy of the decoder over the encoded
    frames.  batch: {"frames": (B, S_enc, d), "tokens": (B, S), "labels":
    (B, S)}; ``params`` in any float dtype, cast once here."""
    params = cast_params(cfg, params)
    enc_h = encode(cfg, params, batch["frames"])
    h = decode_full(cfg, params, batch["tokens"], enc_h)
    labels = batch["labels"]
    return chunked_cross_entropy(
        h, params, labels, chunk=min(cfg.loss_chunk, labels.shape[1]),
        compute_dtype=compute_dtype(cfg))


# ---------------------------------------------------------------------------
# Serving: the cache and the decode body
# ---------------------------------------------------------------------------

def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)}: the self K/V ``k`` / ``v`` and the cross
    K/V ``cross_k`` / ``cross_v``, each (L, B, max_seq, KV, dh): the
    encoder length is ``max_seq``."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {name: (shape, dtype) for name in SELF + CROSS}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16) -> dict:
    """A zeroed cache, cross K/V included (the reference serves with a
    zero cross cache unless one is inserted)."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_spec(cfg, batch, max_seq,
                                                dtype).items()}


def cache_axes(cfg: ArchConfig) -> dict:
    """The self K/V's sequence axis is ``kv_seq`` (a log a step appends
    to); the cross K/V's is ``enc_seq`` (the encoder's, read-only)."""
    axes = {name: ("layers", "batch", "kv_seq", "kv", None) for name in SELF}
    axes.update({name: ("layers", "batch", "enc_seq", "kv", None)
                 for name in CROSS})
    return axes


def build_cross_cache(cfg: ArchConfig, params, enc_h) -> dict:
    """Each decoder layer's cross-attention K/V from the encoder states
    ``enc_h`` (B, S_enc, d), projected in ``enc_h``'s dtype, not roped,
    and rounded to bf16 whatever the compute dtype, as the reference
    has it: {"cross_k", "cross_v"} of (L, B, S_enc, KV, dh)."""
    dt = enc_h.dtype
    out = {name: [] for name in CROSS}
    for l in range(cfg.n_layers):
        cross = _layer(params["decoder"], l)["cross"]
        for name, w in (("cross_k", cross["wk"]), ("cross_v", cross["wv"])):
            out[name].append(attn._proj(enc_h, w.to(dt)).to(torch.bfloat16))
    return {name: torch.stack(v) for name, v in out.items()}


def _decode(cfg: ArchConfig, params, tokens, positions, attend, cross):
    """The single-token decode body.  ``attend(l, layer attn params,
    normed x) -> (B, 1, d)`` runs layer ``l``'s self-attention, appending
    its K/V wherever the caller keeps them; ``cross(l)`` gives layer
    ``l``'s cross K/V {"k", "v"} (B, S_enc, KV, dh), read unmasked.
    Returns the logits (B, vocab_padded) f32."""
    _check_family(cfg)
    h = params["embedding"][tokens.long()]                    # (B, 1, d)
    for l in range(cfg.n_layers):
        lp = _layer(params["decoder"], l)
        h = h + attend(l, lp["attn"], rms_norm(h, lp["attn_norm"]))
        c, _ = attn.decode_attention(
            lp["cross"], rms_norm(h, lp["cross_norm"]), cross(l), positions,
            cross=True, **_attn_kw(cfg))
        h = h + c
        h = h + _mlp(cfg, lp, h)
    h = rms_norm(h, params["final_norm"])
    return (h[:, 0] @ params["lm_head"]).float()


def _dense_cross(cache):
    return lambda l: {"k": cache["cross_k"][l], "v": cache["cross_v"][l]}


def _dense_attend(cfg: ArchConfig, cache, positions, live=None):
    """Self-attention against the dense ``k`` / ``v`` leaves of
    ``cache``, appending at ``positions`` in place; with ``live`` (B,)
    bool only the live slots' appends are kept (a frozen slot's position
    gets its old bits back)."""
    def attend(l, p, xn):
        kv = {"k": cache["k"][l], "v": cache["v"][l]}
        if live is not None:
            b_idx = torch.arange(xn.shape[0], device=xn.device)
            pos = positions.long()
            keep = {name: leaf[b_idx, pos] for name, leaf in kv.items()}
        o, _ = attn.decode_attention(p, xn, kv, positions, **_attn_kw(cfg))
        if live is not None:
            m = live[:, None, None]
            for name, leaf in kv.items():
                leaf[b_idx, pos] = torch.where(m, leaf[b_idx, pos],
                                               keep[name])
        return o

    return attend


def decode_step(cfg: ArchConfig, params, cache, tokens, positions):
    """One decode step.  tokens (B, 1); positions (B,), where the
    self-attention appends; the cross K/V is read as the cache holds it.
    The self K/V is written in place.  Returns (logits (B, vocab_padded)
    f32, cache)."""
    logits = _decode(cfg, params, tokens, positions,
                     _dense_attend(cfg, cache, positions),
                     _dense_cross(cache))
    return logits, cache


def paged_decode_step(cfg: ArchConfig, params, pool, tables, rows, tokens,
                      positions, scales=None, kv_dtype: str = "bf16"):
    """The mixed-pool decode step (serving O6 kernel path): each layer's
    self-attention appends its token's K/V into the slot's active block
    through ``tables`` (B, nb) in place and runs the paged-decode kernel
    on the raw pool leaves (L, R, T, KV, dh) — on a narrow pool
    (``scales`` {"k", "v"} of (L, R, KV) f32) re-quantizing the active
    block; the cross K/V is gathered from the slots' state rows ``rows``
    (B,) into the dense batch view the cross ``decode_attention`` reads
    (parked and idle slots alias the NULL row) and never written back:
    the pool's cross leaves come back unchanged.  Returns (logits,
    pool), or (logits, pool, scales) for a narrow pool."""
    cross = gather_rows(pool, rows, dict.fromkeys(CROSS, 1))

    def attend(l, p, xn):
        kvs = tuple(pool[name][l] for name in SELF)
        if scales is not None:
            kvs += tuple(scales[name][l] for name in SELF)
        o, _ = attn.paged_decode_attention(
            p, xn, kvs, tables, positions, kv_dtype=kv_dtype,
            **_attn_kw(cfg))
        return o

    logits = _decode(cfg, params, tokens, positions, attend,
                     _dense_cross(cross))
    return (logits, pool) if scales is None else (logits, pool, scales)


def prefill_step(cfg: ArchConfig, params, cache, tokens, start, last):
    """Chunked prefill by running the decode body over the chunk
    (``models/scan_prefill``): the self K/V appended in place for live
    slots only, positions clipped to its length; the read-only cross
    leaves pass through untouched (never frozen, never copied).  The
    cache is written in place.  Returns (logits (B, vocab_padded) at the
    ``last`` rows, cache)."""
    def step(c, tok, pos, live):
        return _decode(cfg, params, tok, pos,
                       _dense_attend(cfg, c, pos, live),
                       _dense_cross(c)), c

    return scan_prefill(step, cache, tokens, start, last,
                        logits_width=padded_vocab(cfg.vocab),
                        batch_axes=batch_axes_of(cache_axes(cfg)),
                        max_seq=cache["k"].shape[2], in_place=SELF + CROSS)
