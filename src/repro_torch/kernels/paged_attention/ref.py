"""Plain PyTorch versions of the paged-attention kernel (B1: one query
per slot; B2: Q queries per slot, each with its own causal limit).

A direct transcription of the kernel's two-pass math (and so of the
Pallas reference's ``_scores`` / ``_accumulate`` as XLA compiles them),
vectorized over the gathered dense view instead of walked block by
block: scores rounded to the query dtype, multiplied in float32 by the
dtype-rounded scale, masked with -1e30 past each slot's length, softmax
statistics in float32, probabilities rounded to the query dtype before
the PV product, float32 accumulation and one final round.

The reference's source also rounds the scaled score
(``(s.astype(dt) * scale).astype(dt)``), but XLA's default excess
precision elides that round trip: measured against the JAX kernel in
bf16 at head_dim 128, this transcription agrees on every output bit,
while rounding the product disagrees on ~40% of them.  Positions past a slot's
length (the NULL block, stale tails) never reach a product, so garbage —
even NaN — cannot leak.

``paged_prefill_attention_ref`` transcribes ``_paged_prefill_kernel``
the same way: query ``qi`` of a slot attends positions ``idx < lengths -
(Q - 1 - qi)``, and each row's scores are masked and V zeroed past its
own limit, so nothing past a row's limit — not even a later query's
freshly written K/V — reaches its sums.

Narrow pools (int8 or float8_e4m3fn, with ``k_scale``/``v_scale`` of
(R, KV) f32) are the reference's ``_dequant`` branch: each gathered
block is widened exactly to f32, multiplied in f32 by its (row, kv head)
scale and rounded once to q's dtype — the expression of
``serving.kvquant.dequantize``, inlined so the kernel package imports
nothing of serving.  Everything after is the wide pool's math, so a
narrow pool gives what its pre-dequantized pool gives, bit for bit.

The CPU tests hold both against the JAX kernels in interpret mode, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.
"""

from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


@functools.cache
def kernel_scale(head_dim: int, dtype: torch.dtype) -> float:
    """The kernel's ``1 / sqrt(D)`` rounded to the query dtype (the
    reference multiplies a dtype array by a weak-typed Python float)."""
    return float(torch.tensor(1.0 / (head_dim ** 0.5), dtype=dtype))


def _round(x, dtype):
    return x.to(dtype).float()


def _gathered(pool, scale, rows, shape, dt):
    """The pool rows ``rows`` as f32, reshaped to ``shape`` (B, S, KV, D);
    a narrow pool is dequantized with its (R, KV) ``scale`` and rounded
    to ``dt`` first.  1-byte pools are gathered as bytes (float8 indexing
    may be missing on CUDA)."""
    if scale is None:
        return pool.index_select(0, rows).reshape(shape).float()
    g = pool.view(torch.uint8).index_select(0, rows).view(pool.dtype)
    s = scale.index_select(0, rows)[:, None, :, None]
    return _round(g.float() * s, dt).reshape(shape)


def paged_attention_ref(q, k_pool, v_pool, tables, lengths, k_scale=None,
                        v_scale=None):
    """q: (B, H, D); k_pool/v_pool: (R, T, KV, D); tables: (B, nb) int;
    lengths: (B,) valid positions per slot; k_scale/v_scale: (R, KV) f32
    for a narrow pool, else None.  Returns (B, H, D) in q's dtype; a
    slot of length 0 gets zeros."""
    B, H, D = q.shape
    _, T, KV, _ = k_pool.shape
    nb = tables.shape[1]
    G = H // KV
    dt = q.dtype
    S = nb * T
    rows = tables.reshape(-1).long()
    k = _gathered(k_pool, k_scale, rows, (B, S, KV, D), dt)
    v = _gathered(v_pool, v_scale, rows, (B, S, KV, D), dt)
    valid = (torch.arange(S, device=q.device)[None]
             < lengths.to(q.device)[:, None])                  # (B, S)
    v = torch.where(valid[:, :, None, None], v, 0.0)

    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k)
    s = _round(s, dt) * kernel_scale(D, dt)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(vmask, torch.exp(s - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    p = _round(e / l.clamp_min(1e-30), dt)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, D).to(dt)


def paged_prefill_attention_ref(q, k_pool, v_pool, tables, lengths,
                                k_scale=None, v_scale=None):
    """q: (B, Q, H, D) — Q consecutive queries per slot whose K/V are the
    last Q of ``lengths[b]`` positions; the rest as
    :func:`paged_attention_ref`.  Returns (B, Q, H, D) in q's dtype; a
    row whose limit is below 1 gets zeros."""
    B, Q, H, D = q.shape
    _, T, KV, _ = k_pool.shape
    nb = tables.shape[1]
    G = H // KV
    dt = q.dtype
    S = nb * T
    rows = tables.reshape(-1).long()
    k = _gathered(k_pool, k_scale, rows, (B, S, KV, D), dt)
    v = _gathered(v_pool, v_scale, rows, (B, S, KV, D), dt)
    qi = torch.arange(Q, device=q.device)
    limit = lengths.to(q.device).long()[:, None] - (Q - 1 - qi)[None]
    valid = (torch.arange(S, device=q.device)[None, None]
             < limit[:, :, None])                              # (B, Q, S)
    v = torch.where(valid[..., None, None], v[:, None], 0.0)  # (B,Q,S,KV,D)

    qg = q.reshape(B, Q, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    s = _round(s, dt) * kernel_scale(D, dt)
    vmask = valid[:, None, None]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(vmask, torch.exp(s - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    p = _round(e / l.clamp_min(1e-30), dt)
    o = torch.einsum("bkgqs,bqskd->bqkgd", p, v)
    return o.reshape(B, Q, H, D).to(dt)
