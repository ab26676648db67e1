"""Zamba2-style hybrid: a Mamba-2 trunk and one SHARED attention block
(port of ``repro/models/hybrid.py``).

54 mamba layers in 9 groups of 6; after each group the shared block
(attention + MLP, its weights reused by all 9 applications) runs on
``concat(hidden, embedding output)`` projected down by a per-application
(unshared) ``app_proj`` — the Zamba2 weight-sharing scheme.  The shared
block attends the whole prefix, so its KV cache exists only at the 9
application points.

Layer params are stacked as in the reference: ``mamba`` on a leading L
axis, ``app_proj`` on a leading application axis; its scans over groups
and layers become Python loops.  The mamba layers are ``mamba2``'s own
block and decode step (``A_log`` and ``dt_bias`` kept in float32, as
there); the shared block is the dense family's attention and SwiGLU.

The serving cache is flat and name-keyed like the other families': the
trunk's ``conv`` (L, B, K-1, ch) and ``ssm`` (L, B, H, P, N), both in
the cache dtype, and the shared block's ``k`` / ``v`` (A, B, S, KV, dh),
A = L / attn_every.  The reference nests the same leaves as
``{"mamba": {conv, ssm}, "shared_kv": {k, v}}``.  At O6 the state leaves
live in the state-row pool and the KV leaves in the block pool, so the
paged decode step takes both the block tables and the state rows:
the state is gathered through the rows around the exact decode body and
scattered back, and the shared attention appends to and reads the raw
pool through the tables (kernel B1 on the card; B1q on a narrow pool,
whose scales cover the KV leaves only: state is never quantized).

The chunked prefill runs the decode body over the chunk
(``scan_prefill``): the state leaves are frozen per slot past ``last``
by ``torch.where``, the KV leaves are appended in place on the live
slots' rows only (``in_place``), so a chunk is bit for bit its one-token
steps and a frozen slot's KV positions keep their bits, as the
reference's frozen ``where`` keeps them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (PDef, chunked_cross_entropy,
                                       init_params, mlp_apply, rms_norm,
                                       rms_norm_defs, stack_defs,
                                       swiglu_defs)
from repro_torch.models.remat import resolve_policy, wrap_layer_body
from repro_torch.models.scan_prefill import (batch_axes_of, gather_rows,
                                             scan_prefill, scatter_rows)
from repro_torch.models.transformer import DTYPES, compute_dtype, padded_vocab

STATE = ("conv", "ssm")
KV = ("k", "v")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "hybrid":
        raise ValueError(f"{cfg.name}: hybrid runs the hybrid family, not "
                         f"{cfg.family!r}")
    if cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")


def _n_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def _mamba_kw(cfg: ArchConfig) -> dict:
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                state=cfg.ssm_state, conv_width=cfg.conv_width)


def _layer(tree: dict, l: int) -> dict:
    """Views of layer ``l`` of a stacked subtree."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def model_defs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    vp = padded_vocab(cfg.vocab)
    return {
        "embedding": PDef((vp, d), "small"),
        "lm_head": PDef((d, vp)),
        "final_norm": rms_norm_defs(d),
        "mamba": stack_defs(mamba2.mamba2_defs(d, **_mamba_kw(cfg)),
                            cfg.n_layers),
        "shared": {
            "attn_norm": rms_norm_defs(d),
            "attn": attn.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim),
            "mlp_norm": rms_norm_defs(d),
            "mlp": swiglu_defs(d, cfg.d_ff),
        },
        "app_proj": PDef((_n_apps(cfg), 2 * d, d), "small"),
    }


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device, dtype=None) -> dict:
    """Random weights drawn on ``device`` from ``generator`` in ``dtype``
    (default the compute dtype), but the trunk's ``A_log`` and
    ``dt_bias`` in float32, as the reference reads them."""
    params = init_params(model_defs(cfg), generator, device,
                         dtype or compute_dtype(cfg))
    for k in mamba2._F32_LEAVES:
        params["mamba"][k] = params["mamba"][k].float()
    return params


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------

def _shared_block(cfg: ArchConfig, shared, proj, h, emb0, positions):
    x = torch.cat([h, emb0], dim=-1) @ proj
    a = attn.attention(
        shared["attn"], rms_norm(x, shared["attn_norm"]), positions,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        causal=True, rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
        scores_dtype=DTYPES[cfg.scores_dtype])
    x = x + a
    m = mlp_apply(shared["mlp"], rms_norm(x, shared["mlp_norm"]),
                  cfg.mlp_kind)
    return h + (x + m)


def forward(cfg: ArchConfig, params, tokens):
    """tokens (B, S) -> final-normed hidden (B, S, d).  ``params`` as
    ``mamba2.cast_params`` gives them; each mamba layer runs under the
    config's remat policy, as the reference wraps its inner body."""
    _check_family(cfg)
    h = params["embedding"][tokens.long()]
    emb0 = h
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    kw = _mamba_kw(cfg)

    def body(h, lp):
        return h + mamba2.mamba2_apply(lp, h, **kw)

    body_fn = wrap_layer_body(body, resolve_policy(cfg))
    per = cfg.attn_every
    for a in range(_n_apps(cfg)):
        for i in range(per):
            h = body_fn(h, _layer(params["mamba"], a * per + i))
        h = _shared_block(cfg, params["shared"], params["app_proj"][a], h,
                          emb0, positions)
    return rms_norm(h, params["final_norm"])


def lm_loss(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy.  batch: {"tokens": (B, S),
    "labels": (B, S)}; ``params`` in any float dtype, cast once here
    (``mamba2.cast_params``: the trunk's ``A_log`` and ``dt_bias`` stay
    as they are)."""
    params = mamba2.cast_params(cfg, params)
    h = forward(cfg, params, batch["tokens"])
    labels = batch["labels"]
    return chunked_cross_entropy(
        h, params, labels, chunk=min(cfg.loss_chunk, labels.shape[1]),
        compute_dtype=compute_dtype(cfg))


# ---------------------------------------------------------------------------
# Serving: the cache and the decode body
# ---------------------------------------------------------------------------

def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)}: the trunk's ``conv`` and ``ssm`` (L, B,
    ...) and the shared block's ``k`` / ``v`` (A, B, S, KV, dh)."""
    per = mamba2.mamba2_state_spec(batch, cfg.d_model, dtype=dtype,
                                   **_mamba_kw(cfg))
    spec = {name: ((cfg.n_layers,) + shape, dt)
            for name, (shape, dt) in per.items()}
    kv = (_n_apps(cfg), batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    spec.update({name: (kv, dtype) for name in KV})
    return spec


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16) -> dict:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_spec(cfg, batch, max_seq,
                                                dtype).items()}


def cache_axes(cfg: ArchConfig) -> dict:
    kv = ("layers", "batch", "kv_seq", "kv", None)
    return {"conv": ("layers", "batch", None, "mlp"),
            "ssm": ("layers", "batch", "heads", None, None),
            "k": kv, "v": kv}


def _decode(cfg: ArchConfig, params, state, tokens, out, attend):
    """The single-token decode body: layer ``l`` of the ``state`` leaves
    (``conv``, ``ssm``) is read and its new state written into layer
    ``l`` of ``out`` (``state`` itself for an in-place step); after each
    group of ``attn_every`` layers, ``attend(a, normed x) -> (B, 1, d)``
    runs application ``a`` of the shared attention, appending its K/V
    wherever the caller keeps them.  Returns the logits (B,
    vocab_padded) f32."""
    _check_family(cfg)
    shared = params["shared"]
    kw = _mamba_kw(cfg)
    h = params["embedding"][tokens.long()]                    # (B, 1, d)
    emb0 = h
    per = cfg.attn_every
    for a in range(_n_apps(cfg)):
        for l in range(a * per, (a + 1) * per):
            o, new = mamba2.mamba2_decode(
                _layer(params["mamba"], l), h,
                {name: state[name][l] for name in STATE}, **kw)
            h = h + o
            for name in STATE:
                out[name][l].copy_(new[name])
        x = torch.cat([h, emb0], dim=-1) @ params["app_proj"][a]
        x = x + attend(a, rms_norm(x, shared["attn_norm"]))
        m = mlp_apply(shared["mlp"], rms_norm(x, shared["mlp_norm"]),
                      cfg.mlp_kind)
        h = h + (x + m)
    h = rms_norm(h, params["final_norm"])
    return (h[:, 0] @ params["lm_head"]).float()


def _dense_attend(cfg: ArchConfig, params, cache, positions, live=None):
    """The shared attention against the dense ``k`` / ``v`` leaves of
    ``cache``, appending at ``positions`` in place; with ``live`` (B,)
    bool only the live slots' appends are kept (a frozen slot's position
    gets its old bits back)."""
    shared = params["shared"]["attn"]

    def attend(a, xn):
        kv = {name: cache[name][a] for name in KV}
        if live is not None:
            b_idx = torch.arange(xn.shape[0], device=xn.device)
            pos = positions.long()
            keep = {name: leaf[b_idx, pos] for name, leaf in kv.items()}
        o, _ = attn.decode_attention(
            shared, xn, kv, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta)
        if live is not None:
            m = live[:, None, None]
            for name, leaf in kv.items():
                leaf[b_idx, pos] = torch.where(m, leaf[b_idx, pos],
                                               keep[name])
        return o

    return attend


def decode_step(cfg: ArchConfig, params, cache, tokens, positions):
    """One decode step.  tokens (B, 1); positions (B,), where the shared
    attention appends.  The cache is written in place.  Returns (logits
    (B, vocab_padded) f32, cache)."""
    logits = _decode(cfg, params, cache, tokens, cache,
                     _dense_attend(cfg, params, cache, positions))
    return logits, cache


def paged_decode_step(cfg: ArchConfig, params, pool, tables, rows, tokens,
                      positions, scales=None, kv_dtype: str = "bf16"):
    """The mixed-pool decode step (serving O6 kernel path): the trunk's
    state is gathered from its pool rows ``rows`` (B,), stepped by the
    exact decode body and scattered back (parked and idle slots alias
    the NULL row); each application of the shared attention appends its
    token's K/V into the slot's active block through ``tables`` (B, nb)
    in place and runs the paged-decode kernel on the raw pool leaves (A,
    R, T, KV, dh) — on a narrow pool (``scales`` {"k", "v"} of (A, R, KV)
    f32) re-quantizing the active block, as the dense family's does.
    Returns (logits, pool), or (logits, pool, scales) for a narrow
    pool."""
    bax = {name: 1 for name in STATE}
    state = gather_rows(pool, rows, bax)
    shared = params["shared"]["attn"]

    def attend(a, xn):
        kvs = tuple(pool[name][a] for name in KV)
        if scales is not None:
            kvs += tuple(scales[name][a] for name in KV)
        o, _ = attn.paged_decode_attention(
            shared, xn, kvs, tables, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, kv_dtype=kv_dtype)
        return o

    logits = _decode(cfg, params, state, tokens, state, attend)
    scatter_rows(pool, rows, state, bax)
    return (logits, pool) if scales is None else (logits, pool, scales)


def scan_body(cfg: ArchConfig, params):
    """The decode body as ``scan_prefill`` runs it with ``in_place=KV``:
    fresh state leaves, the K/V appended in place for live slots."""
    def step(c, tok, pos, live):
        new = {name: torch.empty_like(c[name]) for name in STATE}
        new.update({name: c[name] for name in KV})
        return _decode(cfg, params, c, tok, new,
                       _dense_attend(cfg, params, c, pos, live)), new
    return step


def prefill_step(cfg: ArchConfig, params, cache, tokens, start, last):
    """Chunked prefill by running the decode body over the chunk
    (``models/scan_prefill``): the state frozen per slot past ``last``,
    the K/V appended in place for live slots only, positions clipped to
    the KV leaf's length.  The cache is written in place.  Returns
    (logits (B, vocab_padded) at the ``last`` rows, cache)."""
    return scan_prefill(scan_body(cfg, params), cache, tokens, start, last,
                        logits_width=padded_vocab(cfg.vocab),
                        batch_axes=batch_axes_of(cache_axes(cfg)),
                        max_seq=cache["k"].shape[2], in_place=KV)
