"""Plain PyTorch version of kernel B3: blocked softmax attention, as one
dense product.

The reference's ``attention_ref`` (``repro/kernels/flash_attention/
ref.py``) extended to what ``flash_attention_pallas`` computes: GQA by
index (query head h reads kv head ``h // (H // Hkv)``, K/V never
repeated), a causal mask shifted by ``S_kv - S`` (query row r attends kv
positions ``<= r + S_kv - S``), masked scores ``-1e30`` (never -inf), and
f32 math, cast to q's dtype at the end.  The probabilities are
normalised before the product with V, as ``attention_ref`` has it (the
kernel divides its accumulator at the end instead: the same function up
to rounding); ``torch.softmax``'s gradient is the stable one, which the
chunked backward of ``ops.flash_attention`` relies on.  The CPU tests
hold it against the JAX kernel, and ``chip_smoke.py`` holds the CUDA
kernel against it.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q (B, S, H, D); k, v (B, S_kv, Hkv, D), H % Hkv == 0, S_kv >= S
    under a causal mask (any S_kv without one).  Returns (B, S, H, D) in
    q's dtype."""
    B, S, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    # (B, Hkv, G, S, D) against (B, Hkv, S_kv, D): one GQA group per kv
    # head.  The scale is f32, as the kernel's ``dot(q_f32, k_f32) *
    # scale`` has it.
    qf = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    # In place where autograd allows: the scores are the largest tensor.
    s = (qf @ kf.unsqueeze(2).transpose(-1, -2)).mul_(1.0 / D ** 0.5)
    if causal:
        rows = torch.arange(S, device=q.device)[:, None] + (S_kv - S)
        cols = torch.arange(S_kv, device=q.device)[None, :]
        s.masked_fill_(cols > rows, NEG_INF)
    o = torch.softmax(s, dim=-1) @ vf.unsqueeze(2)        # (B,Hkv,G,S,D)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
