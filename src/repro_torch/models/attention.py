"""Attention: GQA with rope / qk-norm — self- or cross-attention over
the whole sequence for training and the encoder (``attention``, kernel
B3), and for serving against a KV cache, dense (contiguous or gathered
view) or straight off a paged pool, for one token per slot (decode) or a
window of C tokens per slot (chunked prefill, speculative verify).

Port of ``repro/models/attention.py`` (``attn_defs``, ``attention`` for
self-attention, causal or not, and cross-attention, ``decode_attention``
with its read-only ``cross`` form,
``chunk_prefill_attention``, ``paged_decode_attention`` and
``paged_chunk_prefill_attention``, on bf16 pools and on narrow int8 /
fp8 pools with per-block scales).  ``attention``'s rounding sites are
B3's (f32 scores and probabilities, one rounding of the output).  The
serving functions' are the reference's as XLA compiles them: scores come
out of the qk product rounded to the compute dtype, are multiplied in
float32 by the head-dim scale rounded to the compute dtype (JAX rounds
the Python-float scale to bf16 as a weak type; XLA's excess precision
then keeps the product in float32 although the source casts it back),
masked with -1e30, softmaxed in float32, and the probabilities are cast
back to the compute dtype before the PV product.

Caches are written IN PLACE (the reference returns new arrays): the
current tokens' K/V land at their slot's positions before attention
reads them.  A window's padded tail writes at clipped positions, so
several rows may write one position; each such write carries the value
of the row that owns the position (``_window_rows``), so which of them
lands — undefined for repeated indices on CUDA — cannot matter, and a
pad row can never overwrite a real row's K/V.

Narrow pools re-quantize around every write (``_quant_block_write``):
the blocks a write touches are dequantized, the new K/V written, the
positions outside the slot's valid prefix zeroed, the scale re-derived
and the blocks quantized again, all in place.  Writes of inactive slots
and of window entries past the table horizon land in the NULL block and
its scale row, which no length ever reaches, so which duplicate write
lands there cannot matter.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_prefill_attention)
from repro_torch.kernels.paged_attention.ref import kernel_scale
from repro_torch.models.layers import PDef, rms_norm, rope
from repro_torch.serving import kvquant

NEG_INF = -1e30


def attn_defs(d: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool = False) -> dict:
    defs = {
        "wq": PDef((d, n_heads, head_dim)),
        "wk": PDef((d, n_kv, head_dim)),
        "wv": PDef((d, n_kv, head_dim)),
        "wo": PDef((n_heads, head_dim, d)),
    }
    if qk_norm:
        defs["q_norm"] = PDef((head_dim,), "ones")
        defs["k_norm"] = PDef((head_dim,), "ones")
    return defs


def _proj(x, w):
    """x (B, T, d) @ w (d, N, k) -> (B, T, N, k) in x's dtype."""
    d, n, k = w.shape
    return (x @ w.reshape(d, n * k)).view(*x.shape[:-1], n, k)


def _project_qkv(params, x, positions, *, qk_norm: bool, rope_theta: float):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    return q, k, v


def _out_proj(o, wo):
    """o (..., H, dh) @ wo (H, dh, d) -> (..., d)."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _chunk_rows(S: int, q_chunk: int) -> int:
    """Query rows per chunk of the reference's chunked attention: S split
    into ``max(1, S // q_chunk)`` equal chunks, or one chunk when they do
    not divide S."""
    n_chunks = max(1, S // q_chunk)
    return S // n_chunks if S % n_chunks == 0 else S


def attention(params, x, positions, *, n_heads, n_kv, head_dim,
              causal=True, qk_norm=False, rope_theta=1e4, q_chunk=1024,
              kv_x=None, kv_positions=None, scores_dtype=torch.float32):
    """Multi-head attention over the whole sequence (the training forward
    and the encoder).  x: (B, S, d); positions: (B, S), rope's angles.

    ``kv_x`` (B, S_kv, d) switches to cross-attention, the reference's
    branch: q from ``x``, k and v from ``kv_x``; q is roped at
    ``positions``, and k at ``kv_positions`` (B, S_kv) only when they are
    given.

    Its core is kernel B3 (``kernels.flash_attention.ops``): the CUDA
    kernel on a CUDA tensor, its plain version on a CPU one.  The causal
    mask is by sequence index — row i attends keys ``<= i`` — which is
    the reference's position mask for the positions ``forward`` passes
    (``arange(S)`` on every row); a non-causal call (the encoder, a
    cross-attention) attends every key, whatever S_kv is beside S.  B3
    keeps scores and probabilities in f32 and rounds once, at its
    output; the reference's bf16 einsums round the scores and the
    probabilities to the compute dtype first, so bf16 agreement with it
    is held to a tolerance (f32 is tight).  The backward recomputes
    ``q_chunk``-row chunks, the reference's per-chunk
    ``jax.checkpoint``.  Returns (B, S, d).
    """
    if scores_dtype != torch.float32:
        raise NotImplementedError(
            f"scores_dtype {scores_dtype} is not ported yet (the §Perf "
            f"bf16-logits knob; ROADMAP A14)")
    if kv_x is None:
        q, k, v = _project_qkv(params, x, positions, qk_norm=qk_norm,
                               rope_theta=rope_theta)
    else:
        q = _proj(x, params["wq"])
        k = _proj(kv_x, params["wk"])
        v = _proj(kv_x, params["wv"])
        if qk_norm:
            q = rms_norm(q, params["q_norm"])
            k = rms_norm(k, params["k_norm"])
        q = rope(q, positions, rope_theta)
        if kv_positions is not None:
            k = rope(k, kv_positions, rope_theta)
    o = flash_attention(q, k, v, causal=causal,
                        q_chunk=_chunk_rows(x.shape[1], q_chunk))
    return _out_proj(o, params["wo"])


def _window_rows(x, positions):
    """The rows of ``x`` (B, C, ...) to write at ``positions`` (B, C), the
    window's clipped positions: row j's own, except that a row whose
    position was clipped writes the row that owns the clipped position
    (``positions - positions[:, :1]`` indexes it), so all writes to one
    position are equal."""
    src = (positions - positions[:, :1]).long()
    src = src.reshape(*src.shape, *([1] * (x.dim() - 2))).expand_as(x)
    return x.gather(1, src)


def _dense_attend(q, ck, cv, positions, wo, *, n_heads, n_kv, head_dim,
                  masked=True):
    """Attention of q (B, T, H, dh) at ``positions`` (B, T) against a
    dense cache (B, S, KV, dh), positions past each row's own masked
    (``masked=False``, a cross-attention, attends them all).  Returns
    (B, T, d)."""
    B, T = positions.shape
    dt = q.dtype
    group = n_heads // n_kv
    S = ck.shape[1]
    # (B, T, KV, G, dh) -> (B, KV, G*T, dh): one GQA group per kv head.
    qg = q.reshape(B, T, n_kv, group, head_dim).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, n_kv, group * T, head_dim)
    s = qg @ ck.to(dt).permute(0, 2, 3, 1)                # (B, KV, G*T, S)
    s = s.float() * kernel_scale(head_dim, dt)         # the kernel's scale
    if masked:
        valid = (torch.arange(S, device=q.device)[None, None]
                 <= positions[:, :, None])                # (B, T, S)
        valid = valid[:, None, None].expand(B, 1, group, T, S)
        s = torch.where(valid.reshape(B, 1, group * T, S), s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dt)
    o = p @ cv.to(dt).permute(0, 2, 1, 3)                 # (B, KV, G*T, dh)
    o = o.reshape(B, n_kv, group, T, head_dim).permute(0, 3, 1, 2, 4)
    return _out_proj(o.reshape(B, T, n_heads, head_dim), wo)


def decode_attention(params, x, cache, positions, *, n_heads, n_kv,
                     head_dim, qk_norm=False, rope_theta=1e4, cross=False):
    """Single-token attention against a dense per-slot KV cache.

    x: (B, 1, d); positions: (B,) current index per slot; cache:
    {"k", "v"} of (B, S, KV, dh), written in place at ``positions``.
    Positions past each slot's own are masked.  ``cross=True`` is the
    reference's read-only cross-attention: q alone is projected and
    roped at ``positions``, the cache (the encoder's K/V, B, S_enc, KV,
    dh) is neither written nor masked.  Returns (out (B, 1, d), cache).
    """
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    if cross:
        q = _proj(x, params["wq"])
        if qk_norm:
            q = rms_norm(q, params["q_norm"])
        q = rope(q, positions[:, None], rope_theta)
        out = _dense_attend(q, ck, cv, positions[:, None], params["wo"],
                            n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                            masked=False)
        return out, cache
    q, k, v = _project_qkv(params, x, positions[:, None], qk_norm=qk_norm,
                           rope_theta=rope_theta)
    b_idx = torch.arange(B, device=x.device)
    pos = positions.long()
    ck[b_idx, pos] = k[:, 0].to(ck.dtype)                 # in place
    cv[b_idx, pos] = v[:, 0].to(cv.dtype)
    out = _dense_attend(q, ck, cv, positions[:, None], params["wo"],
                        n_heads=n_heads, n_kv=n_kv, head_dim=head_dim)
    return out, cache


def chunk_prefill_attention(params, x, cache, positions, *, n_heads, n_kv,
                            head_dim, qk_norm=False, rope_theta=1e4):
    """Multi-token (prompt-chunk or verify-window) attention against a
    dense KV cache — the qlen > 1 sibling of :func:`decode_attention`.

    x: (B, C, d) — C consecutive tokens per slot; positions: (B, C) —
    each token's cache index, clipped for a padded tail (whose writes
    land at future positions, rewritten before first read, and whose
    outputs the caller discards).  Each row's arithmetic is the decode
    path's: per-row projections and rope, a masked f32 softmax over the
    same cache rows.  Returns (out (B, C, d), cache), the cache written
    in place.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, positions, qk_norm=qk_norm,
                           rope_theta=rope_theta)
    ck, cv = cache["k"], cache["v"]
    b_idx = torch.arange(B, device=x.device)[:, None]
    pos = positions.long()
    ck[b_idx, pos] = _window_rows(k, positions).to(ck.dtype)   # in place
    cv[b_idx, pos] = _window_rows(v, positions).to(cv.dtype)
    out = _dense_attend(q, ck, cv, positions, params["wo"],
                        n_heads=n_heads, n_kv=n_kv, head_dim=head_dim)
    return out, cache


def _unpack_paged(kvs):
    """(ck, cv, sk, sv) from the paged kv-leaf tuple: (k, v) pools, plus
    their (R, KV) f32 scales for narrow pools (else None, None)."""
    if len(kvs) == 2:
        return kvs[0], kvs[1], None, None
    return tuple(kvs)


def _quant_block_write(pool, scale, rows, where, new, valid, kv_dtype, dt):
    """The requant-on-append discipline for the pool blocks ``rows`` (any
    index shape I), in place: dequantize them into a (*I, T, KV, dh)
    window (the kernels' and the gather path's rounding site), write
    ``new`` at the window index ``where``, zero the positions outside
    ``valid`` so stale garbage never inflates the absmax, re-derive the
    scale and quantize back.  ``pool`` (R, T, KV, dh) and ``scale``
    (R, KV) are one layer's narrow pool and scales."""
    raw = kvquant.as_bytes(pool)
    lead = rows.dim()
    blk = raw[rows].view(pool.dtype)
    s = scale[rows].reshape(*rows.shape, 1, scale.shape[-1], 1)
    wide = kvquant.dequantize(blk, s, dt)
    wide[where] = new.to(dt)
    wide = torch.where(valid, wide, 0)
    s = kvquant.block_scale(wide, (lead, lead + 2), kv_dtype)
    raw[rows] = kvquant.as_bytes(kvquant.quantize(wide, s, kv_dtype))
    scale[rows] = s.reshape(*rows.shape, scale.shape[-1])


def paged_decode_attention(params, x, kvs, tables, positions, *, n_heads,
                           n_kv, head_dim, qk_norm=False, rope_theta=1e4,
                           kv_dtype="bf16"):
    """Gather-free decode attention against a paged KV block pool.

    x: (B, 1, d); kvs: (k, v) pool leaves (R, T, KV, dh), row 0 the NULL
    block — or (k, v, k_scale, v_scale) with (R, KV) f32 scales for a
    narrow (int8 / fp8) pool; tables: (B, nb) int32 physical pool row
    per logical block; positions: (B,) current index per slot.  The
    current token's K/V is appended IN PLACE at ``tables[b, p // T]``,
    offset ``p % T`` — on a narrow pool the slot's whole ACTIVE block is
    re-quantized around the append (dequantize, write, zero the unwritten
    tail, rescale) — then the paged-decode kernel attends the slot's
    ``p + 1`` valid positions, reading only the blocks they span.
    Inactive slots point every table entry at the NULL block (write
    garbage by design); their outputs are discarded by the engine.
    Returns (out (B, 1, d), kvs).
    """
    B = x.shape[0]
    dt = x.dtype
    ck, cv, sk, sv = _unpack_paged(kvs)
    T = ck.shape[1]
    q, k, v = _project_qkv(params, x, positions[:, None], qk_norm=qk_norm,
                           rope_theta=rope_theta)
    b_idx = torch.arange(B, device=x.device)
    pos = positions.long()
    row = tables[b_idx, pos // T].long()
    off = pos % T
    lengths = (positions + 1).to(torch.int32)
    if sk is None:
        ck[row, off] = k[:, 0].to(ck.dtype)               # in place
        cv[row, off] = v[:, 0].to(cv.dtype)
        o = paged_attention(q[:, 0], ck, cv, tables, lengths)
    else:
        valid = (torch.arange(T, device=x.device)[None]
                 <= off[:, None])[..., None, None]        # (B, T, 1, 1)
        for pool, scale, new in ((ck, sk, k), (cv, sv, v)):
            _quant_block_write(pool, scale, row, (b_idx, off), new[:, 0],
                               valid, kv_dtype, dt)
        o = paged_attention(q[:, 0], ck, cv, tables, lengths, k_scale=sk,
                            v_scale=sv)
    return _out_proj(o.to(dt), params["wo"])[:, None], kvs


def paged_chunk_prefill_attention(params, x, kvs, tables, positions,
                                  lengths, *, n_heads, n_kv, head_dim,
                                  qk_norm=False, rope_theta=1e4,
                                  kv_dtype="bf16", start=None):
    """Multi-token attention straight off the paged block pool — the
    qlen > 1 sibling of :func:`paged_decode_attention`.

    x: (B, C, d); kvs: (k, v) pool leaves (R, T, KV, dh), or (k, v,
    k_scale, v_scale) for a narrow pool; tables: (B, nb); positions:
    (B, C) cache index per window token, clipped for the padded tail
    (those writes go to in-reservation future positions or the NULL
    block, both write-garbage-safe); lengths: (B,) UNCLIPPED ``start +
    C``, so each real row's causal limit stays exact; ``start`` (B,)
    anchors a narrow pool's requant window.  The window's K/V are
    scattered into the pool through the tables in place — a narrow pool
    re-quantizes the ``ceil(C / T) + 1`` blocks from ``start // T``
    (entries past the table horizon redirected to the NULL block, never
    clipped onto a real row) — then the multi-query paged kernel (B2)
    attends the whole prefix.  Returns (out (B, C, d), kvs).
    """
    B, C, _ = x.shape
    dt = x.dtype
    ck, cv, sk, sv = _unpack_paged(kvs)
    T = ck.shape[1]
    nb = tables.shape[1]
    q, k, v = _project_qkv(params, x, positions, qk_norm=qk_norm,
                           rope_theta=rope_theta)
    k, v = _window_rows(k, positions), _window_rows(v, positions)
    pos = positions.long()
    if sk is None:
        rows = tables.long().gather(1, pos // T)           # (B, C)
        offs = pos % T
        ck[rows, offs] = k.to(ck.dtype)                    # in place
        cv[rows, offs] = v.to(cv.dtype)
        o = paged_prefill_attention(q.contiguous(), ck, cv, tables,
                                    lengths.to(torch.int32))
        return _out_proj(o.to(dt), params["wo"]), kvs

    from repro_torch.serving.paged import NULL_BLOCK

    dev = x.device
    nt = min((C - 1) // T + 2, nb)
    jb_first = start.long() // T                          # (B,)
    jbs = jb_first[:, None] + torch.arange(nt, device=dev)[None]  # (B, nt)
    in_table = tables.long().gather(1, jbs.clamp(0, nb - 1))
    rows = torch.where(jbs < nb, in_table, NULL_BLOCK)
    bi = torch.arange(B, device=dev)[:, None]
    wi = (pos // T - jb_first[:, None]).clamp(0, nt - 1)  # (B, C)
    woff = pos % T
    abs_idx = jbs[:, :, None] * T + torch.arange(T, device=dev)[None, None]
    valid = (abs_idx < lengths.to(dev).long()[:, None, None])[..., None, None]
    for pool, scale, new in ((ck, sk, k), (cv, sv, v)):
        _quant_block_write(pool, scale, rows, (bi, wi, woff), new, valid,
                           kv_dtype, dt)
    o = paged_prefill_attention(q.contiguous(), ck, cv, tables,
                                lengths.to(torch.int32), k_scale=sk,
                                v_scale=sv)
    return _out_proj(o.to(dt), params["wo"]), kvs
